"""qwen1.5-0.5b [dense] 24L d=1024 16H (kv=16) ff=2816 V=151936 — QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import (ArchSpec, ModelConfig, PipelinePlan,
                                      register, shrink)

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=2816, vocab_size=151936,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf")

SMOKE = shrink(CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
               d_ff=160, vocab_size=512)

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=4, tensor=2, replica=2, microbatches=4),
        "prefill_32k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=4, tensor=2, replica=2, microbatches=2),
        "long_500k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=1,
                                  seq_parallel_kv=True),
    },
    skip_shapes=("long_500k",),   # pure full attention (DESIGN.md §5)
))
