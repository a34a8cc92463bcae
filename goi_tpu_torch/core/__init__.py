from goi_tpu_torch.core.scene import GaussianScene
from goi_tpu_torch.core.camera import Camera

__all__ = ["GaussianScene", "Camera"]
