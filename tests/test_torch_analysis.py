"""The port's static analysis (``repro_torch.analysis``) on its own: the
port-only lint rules, the Hopper kernel launch layer (launch records, the
shared-memory and thread limits against the analytic gate, write races,
the ptxas report's registers and spills, signature contracts), the
registry audits and the CLI.  The parity with ``repro.analysis`` is in
``tests/test_torch_analysis_parity.py``.  No jax is imported here.
"""

import functools
import json
import os
import textwrap

import pytest
import torch

from repro_torch.analysis import audits, contracts, engine, kernels
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core.spaces import Option
from repro_torch.envs import measure
from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.cuda_lib import LaunchRecord, Tile
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.paged_attention import kernel as pk
from repro_torch.utils import hardware

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint(tmp_path, source, name="snippet.py"):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return contracts.lint_file(str(path))


def _lines(findings, rule):
    return sorted(f.line for f in findings if f.rule == rule)


# --------------------------------------------------------------------------
# the port-only lint rules, one fixture each, with the line of each finding
# --------------------------------------------------------------------------

def test_port_import_boundary(tmp_path):
    findings = _lint(tmp_path, """\
        import jax
        import jax.numpy as jnp
        from jaxlib import xla_client
        from repro.kernels import dispatch
        import repro
        import repro_torch
        from repro_torch.kernels import dispatch as port_dispatch
        from . import sibling
    """)
    assert _lines(findings, "port-import-boundary") == [1, 2, 3, 4, 5]


def test_kernel_import_location(tmp_path):
    src = """\
        import ctypes
        import triton
        import triton.language as tl
        from torch.utils.cpp_extension import load
        from torch.utils import cpp_extension
        from repro_torch.kernels import cuda_lib
        from torch.utils import data
    """
    assert _lines(_lint(tmp_path, src), "kernel-import-location") == \
        [1, 2, 3, 4, 5]
    for legal in ("repro_torch/kernels/fam/kernel.py",
                  "repro_torch/kernels/cuda_lib.py"):
        assert _lines(_lint(tmp_path, src, name=legal),
                      "kernel-import-location") == [], legal


def test_version_gate(tmp_path):
    findings = _lint(tmp_path, """\
        import torch
        import torch.nn.functional as F
        from torch import cuda

        def probe(obj):
            a = getattr(torch, "compile", None)
            b = hasattr(torch.cuda, "graphs")
            c = getattr(F, "scaled_dot_product_attention", None)
            d = hasattr(cuda, "MemPool")
            return a, b, c, d, getattr(obj, "x", None)
    """)
    assert _lines(findings, "version-gate") == [6, 7, 8, 9]


def test_torch_global_rng(tmp_path):
    findings = _lint(tmp_path, """\
        import torch
        from torch import randn

        def f(seed):
            torch.manual_seed(seed)
            torch.cuda.manual_seed_all(seed)
            a = torch.randn(3)
            b = randn(2)
            c = torch.random.fork_rng()
            s = torch.seed()
            gen = torch.Generator()
            gen.manual_seed(seed)
            d = torch.randint(0, 5, (2,), generator=gen)
            e = torch.multinomial(a.abs(), 1, generator=gen)
            g = torch.Generator().manual_seed(seed)
            return a, b, c, s, d, e, g
    """)
    assert _lines(findings, "unseeded-randomness") == [5, 6, 7, 8, 9, 10]


def test_seeded_torch_generator_is_clean(tmp_path):
    findings = _lint(tmp_path, """\
        import torch

        def f(seed, shape):
            gen = torch.Generator(device="cpu")
            gen.manual_seed(seed)
            return torch.randn(shape, generator=gen)
    """)
    assert findings == []


# --------------------------------------------------------------------------
# kernel layer: the tree, the limits, races, ptxas, signatures
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def registered():
    return kernels.check_registered_families()


def test_registered_families_are_clean(registered):
    findings, _ = registered
    assert findings == [], [f"{f.rule}: {f.message}" for f in findings]
    assert sorted(dispatch.families()) == [
        "flash_attention", "mamba_scan", "paged_attention", "rmsnorm", "ssd"]


def test_configs_checked_is_the_product_of_the_domains(registered):
    _, checked = registered
    expected = 0
    for family in dispatch.families():
        n = 1
        for o in dispatch.get_family(family).launch_options:
            n *= len(o.values)
        expected += n
        assert len(kernels.option_configs(family)) == n
    assert checked == expected == 87


def test_every_family_gives_records_in_both_dtypes():
    for family in dispatch.families():
        path, line, configs, findings = kernels.family_records(family)
        assert findings == [] and path.endswith("kernel.py") and line > 1
        for params, recs in configs:
            assert {dt for _, dt, _ in recs} == {"float32", "bfloat16"}
            assert all(r.smem <= cuda_lib.SMEM_LIMIT and r.threads <= 1024
                       for _, _, r in recs), (family, params)


def test_one_shared_memory_limit():
    assert (cuda_lib.SMEM_LIMIT == measure.SMEM_LIMIT_BYTES
            == hardware.H100_SXM.vmem_bytes
            == hardware.H100_SMEM_PER_BLOCK == 232448)
    assert measure.KernelWorkload().vmem_limit == hardware.H100_SMEM_PER_BLOCK


def _record(smem, threads=128, grid=(4, 1, 1), in_order=(), writes=None):
    return LaunchRecord("repro::fixture_kernel<float>", grid, (threads, 1, 1),
                        smem, 0, in_order, writes)


def test_smem_budget_fires_past_the_limit():
    over = _record(232449)
    params = {"page_size": 64, "pages_per_slot_max": 8, "prefill_chunk": 0}
    findings, checked = kernels.smem_findings(
        "paged_attention", [(params, [({"d": 64}, "float32", over)])],
        "fixture.py", 3)
    assert checked == 1
    assert [f.rule for f in findings] == ["kernel-smem-budget"]
    assert "232449 shared bytes" in findings[0].message
    at_limit = _record(232448)
    assert kernels.smem_findings(
        "paged_attention", [(params, [({}, "float32", at_limit)])],
        "fixture.py", 3)[0] == []
    too_wide = _record(1024, threads=1056)
    assert [f.rule for f in kernels.smem_findings(
        "paged_attention", [(params, [({}, "float32", too_wide)])],
        "fixture.py", 3)[0]] == ["kernel-smem-budget"]


def test_smem_budget_defers_to_the_analytic_gate(monkeypatch):
    # the Hopper decode's block holds a K/V tile ring, not a page: every
    # page size takes the same shared bytes, and page 256 is admitted
    geometry = measure.LaunchGeometry(measure.KernelWorkload())
    limit = geometry.workload.vmem_limit
    for page in (64, 256):
        paged = {"page_size": page, "pages_per_slot_max": 8,
                 "prefill_chunk": 0}
        assert geometry.family_cost("paged_attention", paged)[2] == 72768
        assert 72768 <= limit
    # a budget between two prefill launches' blocks (head dim 128: 34,816
    # and 69,632 bytes): the gate rejects the larger, and the check defers
    monkeypatch.setattr(measure, "KernelWorkload", functools.partial(
        measure.KernelWorkload, vmem_limit=50_000))
    admitted = {"q_block": 64, "kv_block": 32}
    rejected = dict(admitted, kv_block=64)
    over = [({}, "bfloat16", _record(232449))]
    findings, checked = kernels.smem_findings(
        "flash_attention", [(admitted, over), (rejected, over)],
        "fixture.py", 3)
    assert checked == 2
    assert len(findings) == 1 and "'kv_block': 32" in findings[0].message
    monkeypatch.undo()
    findings, _ = kernels.smem_findings(
        "flash_attention", [(admitted, over), (rejected, over)],
        "fixture.py", 3)
    assert len(findings) == 2  # the default budget admits both
    # a family the geometry does not model: no gate, so it always fires
    findings, _ = kernels.smem_findings("<fixture>", [({}, over)],
                                        "fixture.py", 3)
    assert [f.rule for f in findings] == ["kernel-smem-budget"]


def _rows(idx):  # a row a block on axis 0, 64 columns a block on axis 1
    return (Tile("y", ((idx[0], idx[0] + 1),
                       (idx[1] * 64, idx[1] * 64 + 64))),)


def _aliased(idx):  # every block of a row of the grid writes one tile
    return (Tile("y", ((idx[1], idx[1] + 1), (0, 64))),)


def test_write_race_fires_on_an_aliased_tile_map():
    findings = kernels.race_findings(
        _record(0, grid=(4, 3, 1), writes=_aliased), "fixture.py", 7)
    assert [f.rule for f in findings] == ["kernel-write-race"]
    assert findings[0].line == 7 and "blocks (0, 0, 0) and (1, 0, 0)" in \
        findings[0].message
    # overlapping boxes, not only equal ones
    halves = _record(0, grid=(3, 1, 1), writes=lambda idx: (
        Tile("y", ((0, 1), (idx[0] * 16, idx[0] * 16 + 32))),))
    assert [f.rule for f in kernels.race_findings(halves, "f.py", 1)] == \
        ["kernel-write-race"]
    assert kernels.race_findings(_record(0, grid=(4, 3, 1), writes=_rows),
                                 "fixture.py", 7) == []


def test_write_race_exempts_dimensions_combined_in_order():
    ordered = _record(0, grid=(4, 3, 1), in_order=(0,), writes=_aliased)
    assert kernels.race_findings(ordered, "fixture.py", 7) == []
    # the exemption is per dimension: dimension 1 stays parallel
    crossed = _record(0, grid=(4, 3, 1), in_order=(1,), writes=_aliased)
    assert [f.rule for f in kernels.race_findings(crossed, "f.py", 1)] == \
        ["kernel-write-race"]
    assert [f.rule for f in kernels.race_findings(_record(0), "f.py", 1)] \
        == ["kernel-unanalyzable"]


def test_split_decode_and_ssd_chain_are_combined_in_order():
    shape = dict(d=64, dv=64, g=4, causal=True, decode=True, batch=2,
                 kv_heads=2, sq=80, skv=4096)
    dec = fk.launch_records(shape, torch.bfloat16)[1]
    assert dec.grid[2] > 1 and dec.in_order == (2,)
    assert kernels.race_findings(dec, "f.py", 1) == []
    # every split may be the one that writes the group's output
    parallel = LaunchRecord(dec.kernel, dec.grid, dec.block, dec.dynamic_smem,
                            dec.static_smem, (), dec.writes)
    assert [f.rule for f in kernels.race_findings(parallel, "f.py", 1)] == \
        ["kernel-write-race"]
    from repro_torch.kernels.ssd import kernel as sk
    chain = sk.launch_records(dict(batch=1, len=640, heads=1, p=64, groups=1,
                                   n=64, states=True), torch.bfloat16,
                              chunk=64)[0]
    assert chain.kernel == "repro::ssd_mma_kernel<64, float>"
    assert chain.grid == (5, 1, 1) and chain.in_order == (0,)
    # blocks 0 and 2 of the pair hand their states on through one slot
    assert any(a.overlaps(b) for a in chain.writes((0, 0, 0))
               for b in chain.writes((2, 0, 0)))
    assert kernels.race_findings(chain, "f.py", 1) == []


@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (192, 128)])
@pytest.mark.parametrize("kv_block", [32, 64])
def test_prefill_smem_mirrors_hand_counts(d, dv, kv_block):
    # fp32 SIMT: kv_block rows of K (d) and V (dv) floats
    assert fk.prefill_smem_bytes(d, dv, kv_block, 4) == \
        kv_block * (d + dv) * 4
    # bf16 MmaTile<d, dv, kv_block>: 2 stages x BN x (d + 8 + dv + 8) x 2
    assert fk.prefill_smem_bytes(d, dv, kv_block, 2) == \
        2 * kv_block * (d + 8 + dv + 8) * 2
    # (16, 8): V padded to 16 columns
    assert fk.prefill_smem_bytes(16, 8, kv_block, 2) == \
        2 * kv_block * (16 + 8 + 16 + 8) * 2


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("kv_block", [32, 64])
def test_decode_smem_mirror_hand_counts(d, g, kv_block):
    floats = (2 * g * d + g * kv_block + 3 * g) * 4
    assert fk.decode_smem_bytes(kv_block, d, g, 4) == \
        2 * kv_block * (d + 4 + d) * 4 + floats
    assert fk.decode_smem_bytes(kv_block, d, g, 2) == \
        2 * kv_block * (d + 8 + d) * 2 + floats
    rec = pk.launch_records(dict(d=d, g=g, batch=2, kv_heads=2),
                            torch.float32)[0]
    assert rec.dynamic_smem == fk.decode_smem_bytes(64, d, g, 4)
    assert rec.static_smem == 16 and rec.block == (128, 1, 1)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5repro14rmsnorm_kernelIfLi4ELb1EEEvPKT_S3_S3_PS1_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro14rmsnorm_kernelIfLi4ELb1EEEvPKT_S3_S3_PS1_iifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 32 bytes smem, 408 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5repro4scan21selective_scan_kernelI13__nv_bfloat16S2_Li32EEEvNS0_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro4scan21selective_scan_kernelI13__nv_bfloat16S2_Li32EEEvNS0_6ParamsE
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 464 bytes cmem[0]
"""


def test_ptxas_usage_parses_registers_spills_and_smem():
    usage = kernels.ptxas_usage(PTXAS_LOG)
    rms = "_ZN5repro14rmsnorm_kernelIfLi4ELb1EEEvPKT_S3_S3_PS1_iifi"
    scan = ("_ZN5repro4scan21selective_scan_kernelI13__nv_bfloat16S2_Li32EE"
            "EvNS0_6ParamsE")
    assert usage == {rms: kernels.PtxasUsage(40, 0, 0, 32),
                     scan: kernels.PtxasUsage(255, 12, 8, 0)}
    assert kernels.instance_name(rms) == "repro::rmsnorm_kernel<float, 4, true>"
    # S2_: the substitution of the first template argument's type
    assert kernels.instance_name(scan) == \
        "repro::scan::selective_scan_kernel<__nv_bfloat16, __nv_bfloat16, 32>"


@pytest.mark.parametrize("symbol,name", [
    ("_ZN5repro14rmsnorm_kernelI13__nv_bfloat16Li16ELb0EEEvPKT_S4_S4_PS2_iifi",
     "repro::rmsnorm_kernel<__nv_bfloat16, 16, false>"),
    ("_ZN5repro10ssd_kernelI13__nv_bfloat16fS1_EEvPKT_PKT0_",
     "repro::ssd_kernel<__nv_bfloat16, float, __nv_bfloat16>"),
    ("_ZN5repro4scan21selective_scan_kernelIffLi4EEEvNS0_6ParamsE",
     "repro::scan::selective_scan_kernel<float, float, 4>"),
    ("_ZN5repro4scan21selective_scan_kernelIfS9_Li4EEEvNS0_6ParamsE", None),
    ("_ZN5repro4scan21selective_scan_kernelIf13__nv_bfloat16Li4EEEvNS0_6"
     "ParamsE", "repro::scan::selective_scan_kernel<float, __nv_bfloat16, 4>"),
    ("_ZN5repro23decode_attention_kernelIfLb1EEEvNS_10DecodeArgsE",
     "repro::decode_attention_kernel<float, true>"),
    ("_ZN5repro26flash_attention_mma_kernelILi192ELi128ELi64EEEvPK13__nv_"
     "bfloat16S3_S3_PS1_iiiiiiffi",
     "repro::flash_attention_mma_kernel<192, 128, 64>"),
    ("_ZN5repro14ssd_mma_kernelILi80EfEEvPK13__nv_bfloat16PKT0_",
     "repro::ssd_mma_kernel<80, float>"),
    ("_Z6squarePfi", "square"),
    ("not_mangled", None),
])
def test_instance_name(symbol, name):
    assert kernels.instance_name(symbol) == name


def test_canonical_name_reads_demangled_forms():
    want = "repro::rmsnorm_kernel<float, 4, true>"
    for text in ("void repro::rmsnorm_kernel<float, 4, true>(float const*, "
                 "float const*, float const*, float*, int, int, float, int)",
                 "void repro::rmsnorm_kernel<float, (int)4, (bool)1>(const "
                 "float *, const float *, const float *, float *, int, int, "
                 "float, int)", want):
        assert kernels.canonical_name(text) == want


def test_register_budget_and_spill_rules_fire():
    usage = kernels.ptxas_usage(PTXAS_LOG)
    by_instance = kernels.usage_by_instance(usage)
    name = "repro::rmsnorm_kernel<float, 4, true>"
    fits = LaunchRecord(name, (1, 1, 1), (1024, 1, 1), 0, 32)
    assert kernels.register_findings([fits], by_instance, "f.py", 1) == []
    heavy = dict(by_instance)
    heavy[name] = kernels.PtxasUsage(72, 0, 0, 32)
    over = kernels.register_findings([fits], heavy, "f.py", 1)
    assert [f.rule for f in over] == ["kernel-register-budget"]
    assert "72 registers x 1024 threads = 73728" in over[0].message
    missing = LaunchRecord("repro::absent<float>", (1, 1, 1), (32, 1, 1), 0)
    assert [f.rule for f in kernels.register_findings(
        [missing], by_instance, "f.py", 1)] == ["kernel-unanalyzable"]
    spills = kernels.spill_findings(usage, "f.py", 1)
    assert [(f.rule, f.severity) for f in spills] == [
        ("kernel-spill", engine.WARNING)]
    assert "12 bytes stored, 8 bytes loaded" in spills[0].message


def test_signature_and_unused_option_findings(monkeypatch):
    fam = dispatch.KernelFamily(
        name="mismatched",
        kernel="repro_torch.kernels.rmsnorm.kernel:rmsnorm_cuda",
        ref="repro_torch.kernels.flash_attention.ref:attention_blockwise_ref",
        launch_options=(Option("row_block", (1, 2)),
                        Option("nope", (1, 2))))
    monkeypatch.setitem(dispatch._REGISTRY, "mismatched", fam)
    findings = kernels.signature_findings("mismatched")
    assert sorted(f.rule for f in findings) == [
        "kernel-option-unused", "kernel-signature"]
    sig = next(f for f in findings if f.rule == "kernel-signature")
    assert "['x', 'weight'] != ref required positionals ['q', 'k', 'v']" in \
        sig.message and sig.path.endswith("rmsnorm/kernel.py")
    unused = next(f for f in findings if f.rule == "kernel-option-unused")
    assert "['nope']" in unused.message
    # the paged family's pool options land on the plan that takes them
    assert kernels.signature_findings("paged_attention") == []
    paged = dispatch.get_family("paged_attention")
    monkeypatch.setitem(dispatch._REGISTRY, "paged_attention",
                        dispatch.KernelFamily(paged.name, paged.kernel,
                                              paged.ref,
                                              paged.launch_options))
    assert [f.rule for f in kernels.signature_findings("paged_attention")] \
        == ["kernel-option-unused"]


def test_family_without_a_launch_plan_is_unanalyzable(monkeypatch):
    fam = dispatch.KernelFamily(
        name="planless",
        kernel="repro_torch.kernels.rmsnorm.ref:rmsnorm_ref",
        ref="repro_torch.kernels.rmsnorm.ref:rmsnorm_ref",
        launch_options=(Option("eps", (1e-5,)),))
    monkeypatch.setitem(dispatch._REGISTRY, "planless", fam)
    findings, checked = kernels.check_family("planless")
    assert [(f.rule, f.severity) for f in findings] == [
        ("kernel-unanalyzable", engine.WARNING)]
    assert checked == 0


# --------------------------------------------------------------------------
# registry audits
# --------------------------------------------------------------------------

def test_audits_clean_on_the_port():
    assert audits.run_audits() == []


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def test_cli_gate_exit_codes_and_formats(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\nimport jax\nT0 = time.time()\n")
    missing = str(tmp_path / "no_baseline.json")
    common = ["--no-kernels", "--no-audits", "--baseline", missing]
    assert cli_main([str(bad), "--gate", *common]) == 1
    out = capsys.readouterr().out
    assert "[wall-clock]" in out and "[port-import-boundary]" in out
    assert cli_main([str(bad), *common]) == 0  # no --gate: report only
    capsys.readouterr()

    assert cli_main([str(bad), "--format", "json", *common]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["summary"]["errors"] == 2 and not doc["summary"]["gate_ok"]
    assert sorted(f["rule"] for f in doc["findings"]) == [
        "port-import-boundary", "wall-clock"]

    assert cli_main([str(bad), "--format", "github", "--gate", *common]) == 1
    out = capsys.readouterr().out
    assert "::error file=" in out and "title=port-import-boundary" in out
    assert "::notice::repro_torch.analysis" in out

    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert cli_main([str(good), "--gate", *common]) == 0


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in engine.RULES:
        assert rule in out
    for gone in ("kernel-vmem-budget", "pallas-import-location"):
        assert gone not in out


def test_cli_write_baseline_never_writes_the_references(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["--write-baseline", "--baseline",
                  str(tmp_path / "analysis_baseline.json"), str(tmp_path)])
    assert e.value.code == 2
    assert not (tmp_path / "analysis_baseline.json").exists()
    bad = tmp_path / "legacy.py"
    bad.write_text("import time\nT0 = time.time()\n")
    own = tmp_path / "analysis_baseline_torch.json"
    assert cli_main(["--write-baseline", "--no-kernels", "--no-audits",
                     "--baseline", str(own), str(bad)]) == 0
    assert len(engine.load_baseline(str(own))) == 1
    assert engine.DEFAULT_BASELINE == "analysis_baseline_torch.json"


def test_cli_ptxas_adds_registers_and_spills(tmp_path, capsys, monkeypatch):
    log = tmp_path / "ptxas.log"
    log.write_text(PTXAS_LOG)
    monkeypatch.chdir(REPO_ROOT)
    rc = cli_main(["--gate", "--no-lint", "--no-audits", "--format", "json",
                   "--ptxas", str(log), "--baseline",
                   str(tmp_path / "none.json"), "src/repro_torch"])
    doc = json.loads(capsys.readouterr().out)
    # the fixture log holds two instances: every other record is
    # unanalyzable (a warning) and the spill is a warning, so the gate
    # passes
    assert rc == 0 and doc["summary"]["configs_checked"] == 87
    rules = {f["rule"] for f in doc["findings"]}
    assert rules == {"kernel-spill", "kernel-unanalyzable"}
