from goi_tpu_torch.app.session import QuerySession

__all__ = ["QuerySession"]
