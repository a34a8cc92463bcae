from goi_tpu_torch.query.osh import (OSHState, hinge_loss, osh_finetune,
                                     osh_init, osh_predict)
from goi_tpu_torch.query.similarity import (ape_similarity, clip_relevancy,
                                            decode_semantic_features)

__all__ = ["decode_semantic_features", "ape_similarity", "clip_relevancy",
           "OSHState", "osh_init", "osh_predict", "hinge_loss",
           "osh_finetune"]
