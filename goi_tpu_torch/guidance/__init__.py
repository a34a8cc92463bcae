from goi_tpu_torch.guidance.samplers import SDXLInpaint, inpaint_sample
from goi_tpu_torch.guidance.sds import (CDS, VSD, DiffusionBackend,
                                        InpaintSDS, LODSInpaintSDS, PlainSDS,
                                        Zero123Backend, Zero123SDS,
                                        dilate_mask)

__all__ = ["DiffusionBackend", "InpaintSDS", "LODSInpaintSDS",
           "PlainSDS", "VSD", "CDS", "Zero123Backend", "Zero123SDS",
           "SDXLInpaint", "inpaint_sample", "dilate_mask"]
