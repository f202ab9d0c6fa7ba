from apvast_torch.models.apvast import ApVast

__all__ = ["ApVast"]
