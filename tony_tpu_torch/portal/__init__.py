from tony_tpu_torch.portal.server import PortalServer

__all__ = ["PortalServer"]
