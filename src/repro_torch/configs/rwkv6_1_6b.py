"""rwkv6-1.6b (Finch) [ssm] 24L d=2048 (attention-free) ff=7168 V=65536 —
data-dependent decay.  [arXiv:2404.05892; unverified]

No KV cache: decode state is O(1) per layer (two token-shift rows and one
hd x hd WKV matrix per head).
"""
from repro_torch.configs.base import (MIXER_RWKV, ArchSpec, LayerKind,
                                      ModelConfig, PipelinePlan, SSMConfig,
                                      register, shrink)

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=7168, vocab_size=65536,
    tie_embeddings=False,
    pattern=(LayerKind(mixer=MIXER_RWKV, mlp="rwkv_cm"),),
    ssm=SSMConfig(head_size=64, decay_lora=64, mix_lora=32),
    source="arXiv:2404.05892; unverified")

SMOKE = shrink(CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
               d_ff=160, vocab_size=512,
               ssm=SSMConfig(head_size=16, decay_lora=8, mix_lora=8))

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=8, tensor=2, replica=1, microbatches=8),
        "prefill_32k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=4, tensor=2, replica=2, microbatches=2),
        # O(1) state: no seq-parallel needed; data axis idles at batch 1
        "long_500k": PipelinePlan(stages=8, tensor=2, replica=1, microbatches=1),
    },
))
