"""qwen1.5-110b [dense] 80L d=8192 64H (GQA kv=8) ff=49152 V=152064 — QKV bias,
untied head.  [hf:Qwen/Qwen1.5-0.5B; hf]

Eight query heads share each kv head (G = 8), the most of any registered
arch and the decode kernel's ``MAX_GROUP``.
"""
from repro_torch.configs.base import (ArchSpec, ModelConfig, PipelinePlan,
                                      register, shrink)

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=False,
    source="hf:Qwen/Qwen1.5-0.5B; hf")

SMOKE = shrink(CONFIG, n_layers=4, d_model=64, n_heads=8, n_kv_heads=2,
               d_ff=160, vocab_size=512)

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=16, tensor=1, replica=1, microbatches=8, fsdp=True),
        "prefill_32k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=8, tensor=2, replica=1, microbatches=4),
        "long_500k": PipelinePlan(stages=8, tensor=2, replica=1, microbatches=1,
                                  seq_parallel_kv=True),
    },
    skip_shapes=("long_500k",),   # pure full attention
))
