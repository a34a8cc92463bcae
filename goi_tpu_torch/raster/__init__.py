from goi_tpu_torch.raster.render import RasterConfig, render, trace

__all__ = ["render", "trace", "RasterConfig"]
