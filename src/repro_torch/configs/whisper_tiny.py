"""whisper-tiny [audio]: enc-dec, conv frontend stubbed as precomputed
frame embeddings. [arXiv:2212.04356; unverified]"""
from repro_torch.config import ARCHS, ModelConfig


@ARCHS.register("whisper_tiny")
def whisper_tiny() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="encdec",
        num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
        d_ff=1536, vocab_size=51865,
        encoder_layers=4, cross_attention=True,
        frontend="audio_frames",
        mlp_gated=False,           # whisper uses GELU MLP
        qkv_bias=True,
        pos_embedding="rope",      # TPU-native adaptation of sinusoidal
        tie_embeddings=True,
        notes="encoder frames stubbed at 1500 positions (30s audio)",
    )
