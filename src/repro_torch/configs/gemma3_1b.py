"""gemma3-1b [dense] 26L d=1152 4H (kv=1) ff=6912 V=262144 — 5:1 local:global.
[hf:google/gemma-3-1b-pt; unverified]  head_dim=256, sliding window 512.

26 layers don't tile by 6: the repeating pattern is 13 layers with the
global ones at positions 5 and 11 (layers 5, 11, 18 and 24), as in the JAX
package.  Local layers keep a ring cache of ``min(max_seq, 512)`` rows.
"""
from repro_torch.configs.base import (ArchSpec, LayerKind, ModelConfig,
                                      PipelinePlan, register, shrink)

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense", n_layers=26, d_model=1152,
    n_heads=4, n_kv_heads=1, d_ff=6912, vocab_size=262144, head_dim=256,
    mlp_act="geglu", rope_theta=1_000_000.0, tie_embeddings=True,
    sliding_window=512, global_every=6,
    pattern=tuple(LayerKind() for _ in range(13)),
    source="hf:google/gemma-3-1b-pt; unverified")

SMOKE = shrink(CONFIG, n_layers=13, d_model=64, n_heads=4, n_kv_heads=1,
               head_dim=16, d_ff=160, vocab_size=512, sliding_window=8)

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=2, tensor=2, replica=4, microbatches=2),
        "prefill_32k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=2, tensor=2, replica=4, microbatches=1),
        "long_500k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1,
                                  seq_parallel_kv=True),
    },
))
