# SemanticBBV's two stages and clustering, in PyTorch.
#   tokenizer.py  multi-dimensional assembly tokenization (copy of repro's)
#   bbe.py        Stage 1: RWKV encoder + self-attention pooling
#   signature.py  Stage 2: freq-weighted Set Transformer + CPI head
#   losses.py     the objectives, forward only
#   clustering.py on-device k-means (++ init, the k-means kernels inside)
#   crossprog.py  accuracy and speedup metrics
#   pipeline.py   end-to-end signature pipeline (Fig 2)
