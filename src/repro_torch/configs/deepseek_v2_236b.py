"""deepseek-v2-236b [moe] 60L d=5120 128H MLA (kv_lora=512) V=102400,
160 routed top-6 + 2 shared, d_expert=1536.  [arXiv:2405.04434; hf]

MLA: q_lora=1536, nope_head_dim=128, rope_head_dim=64, v_head_dim=128.
As in the JAX package, the real model's first dense layer is an MoE layer
like the rest, so every stage holds one layer kind.
"""
from repro_torch.configs.base import (MIXER_MLA, MLP_MOE, ArchSpec, LayerKind,
                                      MLAConfig, MoEConfig, ModelConfig,
                                      PipelinePlan, register, shrink)

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=1536, vocab_size=102400,
    rope_theta=10_000.0, tie_embeddings=False,
    pattern=(LayerKind(mixer=MIXER_MLA, mlp=MLP_MOE),),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    source="arXiv:2405.04434; hf")

SMOKE = shrink(CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
               d_ff=96, vocab_size=512,
               moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                             capacity_factor=4.0),
               mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                             nope_head_dim=16, v_head_dim=16))

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=8, fsdp=True),
        "prefill_32k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=4),
        "long_500k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=1,
                                  seq_parallel_kv=True),
    },
    # MLA compresses the per-token cache but attention over 500k stays dense
    skip_shapes=("long_500k",),
))
