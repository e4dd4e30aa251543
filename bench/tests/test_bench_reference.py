"""The plain references against the port's forward pass at the smoke
sizes on the CPU (both in fp32), on weights the benchmark made, and the
fp8 control's rounding."""

import json
import sys

import pytest
import torch

import bench_smoke_setup as S
from bench_smoke_setup import one_thread  # noqa: F401
from benchkit import spec, weights

sys.path.insert(0, str(S.BENCH / "reference"))
import ref_common  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_thread")


def _config(arch):
    cfg = json.loads((S.BENCH / "configs" / f"{arch}.json").read_text())
    cfg["port"].update(S.SMOKE_PORT[arch])
    return cfg


@pytest.mark.parametrize("arch", sorted(S.SMOKE_PORT))
def test_reference_matches_the_port_forward(arch):
    from repro_torch.models.model import build_model

    config = _config(arch)
    cfg = spec.port_model_config(config)
    dev = torch.device("cpu")
    params = weights.make_params(cfg, 2 ** 31 + 3, dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 37),
                           generator=torch.Generator().manual_seed(0))
    port, _, _ = build_model(cfg, device=dev).forward(params, tokens)
    ref = spec.load_module(S.BENCH / "reference" / f"{config['family']}.py")
    with ref_common.exact_fp32():
        mine = ref_common.mm(ref.hidden(params, config["port"], tokens),
                             ref_common.head(params))
    scale = mine.abs().max()
    torch.testing.assert_close(port, mine, atol=1e-4 * scale, rtol=1e-4)
    # the logits are not flat: the check has ranks to compare
    assert float(mine.std()) > 1e-3


def test_fp8_rounding_keeps_magnitude_and_loses_precision():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 128, generator=g)
    w = torch.randn(128, 32, generator=g)
    exact = ref_common.mm(x, w)
    low = ref_common.mm(x, w, fp8=True)
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.1


def test_weights_are_made_from_the_seed():
    cfg = spec.port_model_config(_config("falcon-mamba-7b"))
    dev = torch.device("cpu")
    a = weights.make_params(cfg, 2 ** 40 + 1, dev)
    b = weights.make_params(cfg, 2 ** 40 + 1, dev)
    c = weights.make_params(cfg, 2 ** 40 + 2, dev)
    wa, wb, wc = (p["blocks"]["sub0"]["mixer"]["w_x"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    # fan-in scaled: rms about 1 / sqrt(d_model)
    assert float(wa.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.2)
    # the head is untied, as published, and drawn at rms 2 / sqrt(d_model)
    head = a["embed"]["lm_head"]
    assert head.shape == (cfg.d_model, cfg.vocab_size)
    assert float(head.std()) == pytest.approx(2 * cfg.d_model ** -0.5,
                                              rel=0.2)
