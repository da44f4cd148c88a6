"""llama-3.2-vision-11b [vlm] 40L d=4096 32H (kv=8) ff=14336 V=128256 —
gated cross-attention image layers every 5th.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Vision frontend stub: a request brings precomputed image tokens
``(B, 1601, d)`` (its ``memory``), which the cross-attention layers read.
The repeating pattern is 5 layers: 4 self attention, then 1 cross
attention whose output enters the residual through ``tanh(gate)``.
"""
from repro_torch.configs.base import (MIXER_CROSS, ArchSpec, LayerKind,
                                      ModelConfig, PipelinePlan, register,
                                      shrink)

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
    rope_theta=500_000.0, tie_embeddings=False, n_memory_tokens=1601,
    pattern=(LayerKind(), LayerKind(), LayerKind(), LayerKind(),
             LayerKind(mixer=MIXER_CROSS)),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified")

SMOKE = shrink(CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2,
               d_ff=160, vocab_size=512, n_memory_tokens=8)

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=8, tensor=2, replica=1, microbatches=8, fsdp=True),
        "prefill_32k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=4),
        "long_500k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=1,
                                  seq_parallel_kv=True),
    },
    skip_shapes=("long_500k",),   # pure full attention backbone
))
