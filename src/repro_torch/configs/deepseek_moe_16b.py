"""deepseek-moe-16b [moe] 28L d=2048 16H (kv=16) V=102400, 64 routed top-6 +
2 shared, fine-grained experts d_expert=1408.  [arXiv:2401.06066; hf]

As in the JAX package, the real model's first dense layer is an MoE layer
like the rest, so every stage holds one layer kind (~0.4% of params).
"""
from repro_torch.configs.base import (MLP_MOE, ArchSpec, LayerKind, MoEConfig,
                                      ModelConfig, PipelinePlan, register,
                                      shrink)

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab_size=102400,
    rope_theta=10_000.0, tie_embeddings=False,
    pattern=(LayerKind(mlp=MLP_MOE),),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    source="arXiv:2401.06066; hf")

SMOKE = shrink(CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
               d_ff=96, vocab_size=512,
               moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                             capacity_factor=4.0))

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=8, fsdp=True),
        "prefill_32k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=4),
        "long_500k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=1,
                                  seq_parallel_kv=True),
    },
    skip_shapes=("long_500k",),   # pure full attention
))
