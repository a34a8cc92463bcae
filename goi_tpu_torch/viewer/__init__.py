from goi_tpu_torch.viewer.app import QueryWebApp
from goi_tpu_torch.viewer.server import NetworkGUI
from goi_tpu_torch.viewer.web import WebViewer

__all__ = ["NetworkGUI", "WebViewer", "QueryWebApp"]
