# Hand-written CUDA kernels for the port's hot spots, one family each:
#   wkv            — Stage-1 RWKV delta-rule recurrence, forward and backward
#                    (state, and its gradient, in registers)
#   set_attention  — fused masked, frequency-weighted set attention (SAB/PMA)
#   kmeans_assign  — nearest-centroid assignment and the fused k-means step
#   flash_attention — streaming-softmax GQA attention of the LM zoo's
#                    prefill and training (causal / window / full /
#                    prefix), forward and backward
# Each family has: ref.py (plain PyTorch version, the CPU path and the
# yardstick the kernel is held to) and ops.py (the wrapper). The CUDA
# sources are in ../csrc; _lib.py builds them with nvcc into one library.
#
# Dispatch is by device, never by an option: a wrapper given CPU tensors
# runs the plain version, given CUDA tensors launches its kernel (or
# raises), and counts its launches in `<wrapper>.launches`.
