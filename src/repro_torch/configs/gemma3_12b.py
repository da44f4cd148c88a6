"""gemma3-12b [dense] 48L d=3840 16H (kv=8) ff=15360 V=262144 — 5:1 local:global.
[hf:google/gemma-3-1b-pt; unverified]  head_dim=256, sliding window 1024.
The repeating pattern is 6 layers (position 5 is global), as in the JAX
package.
"""
from repro_torch.configs.base import (ArchSpec, LayerKind, ModelConfig,
                                      PipelinePlan, register, shrink)

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, d_ff=15360, vocab_size=262144, head_dim=256,
    mlp_act="geglu", rope_theta=1_000_000.0, tie_embeddings=True,
    sliding_window=1024, global_every=6,
    pattern=tuple(LayerKind() for _ in range(6)),
    source="hf:google/gemma-3-1b-pt; unverified")

SMOKE = shrink(CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
               head_dim=16, d_ff=160, vocab_size=512, sliding_window=8,
               pattern=tuple(LayerKind() for _ in range(6)))

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=8, tensor=2, replica=1, microbatches=8, fsdp=True),
        "prefill_32k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=4),
        "long_500k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=1,
                                  seq_parallel_kv=True),
    },
))
