from goi_tpu_torch.semantic.codebook import SemanticDecoder

__all__ = ["SemanticDecoder"]
