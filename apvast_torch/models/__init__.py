from apvast_torch.models.apvast import ApVast
from apvast_torch.models.apvast_fd import ApVastFD
from apvast_torch.models.multi_scene import MultiSceneApVast

__all__ = ["ApVast", "ApVastFD", "MultiSceneApVast"]
