"""jamba-v0.1-52b [hybrid] 32L d=4096 32H (kv=8) ff=14336 V=65536, MoE 16e
top-2: Mamba and attention at 7:1, MoE on every other layer.
[arXiv:2403.19887; hf]

The repeating pattern is one 8-layer Jamba block: positions 0-7 are Mamba
except position 4 (attention); the MLP is dense at even positions and MoE
at odd ones.  Mamba layers carry O(1) state (a ``d_conv - 1``-row conv
history and a ``d_inner x d_state`` SSM state per slot).
"""
from repro_torch.configs.base import (MIXER_ATTN, MIXER_MAMBA, MLP_DENSE,
                                      MLP_MOE, ArchSpec, LayerKind, MoEConfig,
                                      ModelConfig, PipelinePlan, SSMConfig,
                                      register, shrink)

_PATTERN = tuple(
    LayerKind(mixer=(MIXER_ATTN if j == 4 else MIXER_MAMBA),
              mlp=(MLP_MOE if j % 2 == 1 else MLP_DENSE))
    for j in range(8))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536,
    rope_theta=10_000.0, tie_embeddings=False,
    pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, n_shared=0),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887; hf")

SMOKE = shrink(CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
               d_ff=160, vocab_size=512,
               moe=MoEConfig(n_experts=8, top_k=2, d_expert=160, n_shared=0,
                             capacity_factor=4.0),
               ssm=SSMConfig(d_state=8, d_conv=4, expand=2))

register(ArchSpec(
    config=CONFIG, smoke_config=SMOKE,
    default_plans={
        "train_4k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=8, fsdp=True),
        "prefill_32k": PipelinePlan(stages=2, tensor=8, replica=1, microbatches=1),
        "decode_32k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=4),
        "long_500k": PipelinePlan(stages=4, tensor=4, replica=1, microbatches=1,
                                  seq_parallel_kv=True),
    },
))
