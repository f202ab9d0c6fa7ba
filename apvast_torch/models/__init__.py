from apvast_torch.models.apvast import ApVast
from apvast_torch.models.apvast_fd import ApVastFD
from apvast_torch.models.multi_scene import MultiSceneApVast
from apvast_torch.models.vast_offline import vast_offline

__all__ = ["ApVast", "ApVastFD", "MultiSceneApVast", "vast_offline"]
