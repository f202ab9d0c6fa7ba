from apvast_torch.models.apvast import ApVast
from apvast_torch.models.apvast_fd import ApVastFD

__all__ = ["ApVast", "ApVastFD"]
