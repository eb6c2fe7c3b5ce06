# SemanticBBV's two stages and clustering, in PyTorch.
#   tokenizer.py  multi-dimensional assembly tokenization (copy of repro's)
#   bbe.py        Stage 1: RWKV encoder + self-attention pooling, its
#                 pre-training (NTP + NIP) and triplet fine-tuning losses
#   signature.py  Stage 2: freq-weighted Set Transformer + CPI head
#   losses.py     the Stage-2 objectives (autograd differentiates them)
#   clustering.py on-device k-means (++ init, the k-means kernels inside)
#   crossprog.py  accuracy and speedup metrics
#   pipeline.py   end-to-end signature pipeline (Fig 2)
#   simpoint.py   intra-program SimPoint workflow (Fig 4)
from repro_torch.core.bbe import (
    BBEConfig, BBEEncoder, finetune_triplet_loss, pretrain_loss,
)
from repro_torch.core.clustering import kmeans, representatives
from repro_torch.core.simpoint import run_simpoint, classic_bbv_matrix, \
    SimPointResult
