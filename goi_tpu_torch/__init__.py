"""PyTorch/CUDA port of goi_tpu.

Modules mirror goi_tpu's paths and names. Tensors carry their device:
constructors and loaders put their tensors on the CUDA card unless the
caller passes device="cpu"; everything downstream follows the device of
its inputs. On a CUDA tensor the rasterizer launches its hand-written
kernels (raster/csrc); on a CPU tensor it runs their plain PyTorch
versions.
"""
