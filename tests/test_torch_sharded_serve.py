"""Sharded prefill and decode steps of the port on the CPU: gloo ranks on a
``FileStore`` (``torch_sharded_cases``) against one process serving the
same batch, smoke configs in fp32: a prefill, then 3 greedy decode steps.

Cases on two ranks, a ``(1, 2)`` ``("data", "model")`` mesh unless named:
llama3.2-1b (dense GQA) at tp=2, with and without ``sp``;
deepseek-v3-671b (MLA, MoE, experts on the model axis) at tp=2, and with
its experts over the data axes on ``(2, 1)`` (routing groups of 16, so a
rank's prefill tokens form the global batch's groups); falcon-mamba-7b
(Mamba-1), zamba2-2.7b (Mamba-2 and the shared attention block),
llama-3.2-vision-11b (gated cross-attention, gates opened) and
whisper-large-v3 (the encoder-decoder) at tp=2.  On four ranks:
llama3.2-1b at tp=4 (4 query / 2 KV heads: the split cuts through
heads, two ranks hold one KV head) and at tp=2 + fsdp=2 on ``(2, 2)``.
Each rank's logits of its rows are held within 1e-5 + 1e-5 |x| at every
step, its greedy tokens equal one process's, and the collective bytes it
counted in the prefill and in each decode step equal the dry run's trace
of rank 0's prefill and decode steps (``launch.build.lower_step``).
"""

import pytest
import torch

import torch_sharded_cases as sc

torch.set_num_threads(1)

TWO = (
    ("llama-tp2", "llama3.2-1b", 2, 16, dict(tp=2), None),
    ("llama-tp2-sp", "llama3.2-1b", 2, 16, dict(tp=2, sp=True), None),
    ("deepseek-tp2", "deepseek-v3-671b", 2, 16, dict(tp=2), None),
    ("deepseek-ep", "deepseek-v3-671b", 2, 16,
     dict(moe_expert_axis="data", moe_group_size=16),
     ((2, 1), ("data", "model"))),
    ("falcon-mamba-tp2", "falcon-mamba-7b", 2, 16, dict(tp=2), None),
    ("zamba2-tp2", "zamba2-2.7b", 2, 16, dict(tp=2), None),
    ("vision-tp2", "llama-3.2-vision-11b", 2, 16, dict(tp=2), None),
    ("whisper-tp2", "whisper-large-v3", 2, 16, dict(tp=2), None),
)
FOUR = (
    ("llama-tp4-heads-cut", "llama3.2-1b", 2, 16, dict(tp=4), None),
    ("llama-tp2-fsdp2", "llama3.2-1b", 4, 16, dict(tp=2, fsdp=2), None),
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve"))
    return {2: sc.spawn_serve(root, 2, TWO), 4: sc.spawn_serve(root, 4, FOUR)}


@pytest.mark.parametrize("case", TWO, ids=[c[0] for c in TWO])
def test_two_ranks_serve_as_one_process(ranks, case):
    sc.hold_serve(ranks[2], case)


@pytest.mark.parametrize("case", FOUR, ids=[c[0] for c in FOUR])
def test_four_ranks_serve_as_one_process(ranks, case):
    sc.hold_serve(ranks[4], case)
