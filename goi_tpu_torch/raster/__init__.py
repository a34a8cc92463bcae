from goi_tpu_torch.raster.render import RasterConfig, render

__all__ = ["render", "RasterConfig"]
