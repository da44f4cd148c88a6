"""whisper-tiny [audio] 4L enc + 4L dec, d=384 6H ff=1536 V=51865 (padded to
51872 for vocab-parallel sharding).  [arXiv:2212.04356; unverified]

Encoder-decoder with a conv frontend stub: the encoder takes precomputed
frame embeddings ``(B, T, d)``.  Learned positions (``rope_theta = 0``), a
two-matrix gelu MLP, and a cross-attention sub-block after every decoder
layer's self attention (``extra_cross``).
"""
from repro_torch.configs.base import (ArchSpec, LayerKind, ModelConfig,
                                      PipelinePlan, register, shrink)

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=51872,
    mlp_act="gelu", rope_theta=0.0, tie_embeddings=True,
    encoder_layers=4, n_memory_tokens=1500,
    pattern=(LayerKind(extra_cross=True),),
    source="arXiv:2212.04356; unverified")

SMOKE = shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
               d_ff=160, vocab_size=512, encoder_layers=2, n_memory_tokens=10)

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=1, tensor=2, replica=8, microbatches=1),
        "prefill_32k": PipelinePlan(stages=1, tensor=16, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=1, tensor=4, replica=4, microbatches=1),
        "long_500k": PipelinePlan(stages=1, tensor=16, replica=1, microbatches=1),
    },
    skip_shapes=("long_500k",),   # enc-dec; 500k decode outside model family
))
