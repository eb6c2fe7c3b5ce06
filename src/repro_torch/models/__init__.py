# Building blocks of the two stages: layers, the RWKV block (Stage 1),
# the Set Transformer (Stage 2); and the LM zoo's dense decoders:
# attention, transformer, model_zoo.
