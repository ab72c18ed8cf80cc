"""The port's device-discipline analyzer (`repro_torch.analysis`), on the
CPU, and its parity with the reference's analyzer (`repro.analysis`).

  * every AST rule and every graph rule fires exactly once on a fixture of
    its own (source strings written to ``tmp_path``), and the CLI exits
    non-zero on each;
  * the port is clean: the AST layer over ``src/repro_torch`` and the graph
    layer over every registered kernel on the CPU, against the checked-in
    (empty) baseline;
  * the guards guard: stripping any one ``# repro: host-boundary`` from a
    copy of a marked module, or one ``LAUNCHES[...] += 1`` from a copy of a
    kernel wrapper, turns the lint red;
  * the registry: the reference's ten kernel names, the three hand-kernel
    counters, one `LAUNCH_COUNTS` behind the modules' ``LAUNCHES``;
  * parity: baselines cross over both ways, the reference's own AST
    fixtures give the same (rule, line), the kernel names and counter
    owners match under the counter map, and `select_best_batch_device`
    keeps its operands on their device and picks the reference's winners.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis import ast_lint as RAST
from repro.analysis import findings as RF
from repro.analysis import registry as RREG
from repro.core import batch as RB
from repro_torch.analysis import ast_lint, graph_lint, lint, registry
from repro_torch.analysis.findings import Finding, load_baseline, split_baselined, write_baseline
from repro_torch.core import batch as B
from repro_torch.kernels import aig_sim as A
from repro_torch.kernels import cim_logic as K
from repro_torch.kernels import decode_attn  # noqa: F401  (registers its counter)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
REF_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
CPU = "cpu"

#: the modules carrying the ``# repro: kernel-module`` marker
MARKED = ("core/batch.py", "kernels/aig_sim.py", "kernels/cim_logic.py", "launch/system.py",
          "serve/explore_service.py")
#: the reference's counter -> the port's hand-kernel counters
COUNTER_MAP = {"aig_eval_pallas": ("eval_mega", "sig_eval"), "cim_pallas": ("cim",)}
#: the port's hand-kernel counters with no counterpart there (the
#: reference's decode attention is jnp, no Pallas kernel)
PORT_ONLY = {"decode_attn": "repro_torch.kernels.decode_attn"}

# ---------------------------------------------------------------------------
# fixtures: one seeded violation each
# ---------------------------------------------------------------------------

AST_FIXTURES = {
    "ast-host-sync-unannotated": '''
# repro: kernel-module
import torch


def gather_energy(grid):
    dev = grid._raw("energy_nj")
    return dev.cpu()  # VIOLATION: unannotated device->host sync
''',
    "ast-truthy-table": '''
DEFAULT = object()


def pick_model(model: "ModelTable"):
    return model or DEFAULT  # VIOLATION: empty table is falsy
''',
    "ast-launch-no-counter": '''
import ctypes


def launch(lib, instrs, planes, out, stream):
    rc = lib.k2_cim(instrs, 1, 1, planes, 8, 128, out, 8, None, stream)  # VIOLATION
    return rc
''',
    "ast-host-sync-in-compile": '''
import torch


@torch.compile(dynamic=False)
def step(x):
    return x * x.sum().item()  # VIOLATION: a sync in a compiled body
''',
}

GRAPH_FIXTURE = '''
import torch
from repro_torch.analysis import registry

MODULE = "fx.{rule}"


def build(device):
{build}


registry.register_kernel("fx_{name}", MODULE, build, {options})
'''

GRAPH_FIXTURES = {
    "graph-dtype-drift": dict(
        build="    x = torch.ones(4, dtype=torch.float64, device=device)\n"
              "    return registry.KernelExample(fn=lambda x: x.float(), args=(x,))",
        options="x64=True"),
    "graph-host-sync": dict(
        build="    x = torch.ones(4, dtype=torch.float64, device=device)\n"
              "    return registry.KernelExample(fn=lambda x: x if bool(x.sum() > 0) else -x,"
              " args=(x,))",
        options="x64=True"),
    "graph-device-escape": dict(
        build="    x = torch.ones(4, device='meta')  # the operands on meta, whatever the lint's device\n"
              "    return registry.KernelExample(fn=lambda x: torch.ones(x.shape), args=(x,))",
        options="x64=False"),
    "graph-launch-missing": dict(
        build="    x = torch.ones(4, dtype=torch.int32, device=device)\n"
              "    return registry.KernelExample(fn=lambda x: x + 1, args=(x,))",
        options="x64=False, launches=('fx_launch',), launch_devices=('cpu', 'cuda')"),
    "graph-run-error": dict(
        build="    x = torch.ones(4, device=device)\n"
              "    return registry.KernelExample(fn=lambda x: x.reshape(3), args=(x,))",
        options="x64=False"),
}


def ast_fixture(tmp_path, rule: str) -> str:
    p = tmp_path / f"fx_{rule.replace('-', '_')}.py"
    p.write_text(AST_FIXTURES[rule].lstrip())
    return str(p)


def graph_fixture(tmp_path, rule: str) -> str:
    name = rule.replace("-", "_")
    p = tmp_path / f"fx_{name}.py"
    p.write_text(GRAPH_FIXTURE.format(rule=rule, name=name, **GRAPH_FIXTURES[rule]))
    return str(p)


@pytest.mark.parametrize("rule", sorted(AST_FIXTURES))
def test_ast_rule_fires_exactly_once(tmp_path, rule):
    findings = ast_lint.lint_paths([ast_fixture(tmp_path, rule)])
    assert [f.rule for f in findings] == [rule]
    assert findings[0].severity == "error" and findings[0].line > 0
    assert "VIOLATION" in findings[0].context


@pytest.mark.parametrize("rule", sorted(GRAPH_FIXTURES))
def test_graph_rule_fires_exactly_once(tmp_path, rule):
    findings = graph_lint.lint_kernels([graph_fixture(tmp_path, rule)], device=CPU)
    assert [f.rule for f in findings] == [rule]
    assert findings[0].severity == "error" and findings[0].path == f"fx.{rule}"


@pytest.mark.parametrize("rule", sorted(AST_FIXTURES))
def test_cli_fails_on_ast_fixture(tmp_path, capsys, rule):
    assert lint.main(["--no-graph", "--baseline", "", ast_fixture(tmp_path, rule)]) == 1
    assert rule in capsys.readouterr().out


@pytest.mark.parametrize("rule", sorted(GRAPH_FIXTURES))
def test_cli_fails_on_graph_fixture(tmp_path, capsys, rule):
    argv = ["--no-ast", "--baseline", "", "--device", CPU,
            "--kernels-from", graph_fixture(tmp_path, rule)]
    assert lint.main(argv) == 1
    assert rule in capsys.readouterr().out


def test_graph_run_records_ops_syncs_and_launches(tmp_path):
    (spec,) = registry.kernel_specs([graph_fixture(tmp_path, "graph-host-sync")])
    run = graph_lint.run_kernel(spec, CPU)
    assert run.syncs == ["aten._local_scalar_dense.default"]
    assert run.ops["aten.sum.default"] == 1 and run.error is None
    assert torch.equal(run.output, torch.ones(4, dtype=torch.float64))
    # the launch rule: a bump of the declared counter satisfies it
    (spec,) = registry.kernel_specs([graph_fixture(tmp_path, "graph-launch-missing")])
    bumping = dataclasses.replace(spec, build=lambda d: registry.KernelExample(
        fn=lambda: registry.count_launch("fx_launch"), args=()))
    run = graph_lint.run_kernel(bumping, CPU)
    assert run.launches == {"fx_launch": 1} and graph_lint.findings_of(run) == []
    registry.LAUNCH_COUNTS["fx_launch"] -= 1


# ---------------------------------------------------------------------------
# the port is clean
# ---------------------------------------------------------------------------


def test_port_tree_ast_clean():
    findings = ast_lint.lint_paths([PORT], root=REPO)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_registered_kernels_graph_clean_on_the_cpu():
    findings = graph_lint.lint_kernels(device=CPU)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_cli_green_on_the_port(capsys):
    assert lint.main(["--device", CPU]) == 0
    assert capsys.readouterr().out.strip() == "0 new finding(s), 0 baselined, 0 total"


def test_checked_in_baseline_is_empty():
    path = os.path.join(PORT, "analysis", "baseline.json")
    assert json.load(open(path)) == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
def test_cli_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint.main(["--no-ast"])


# ---------------------------------------------------------------------------
# the guards guard
# ---------------------------------------------------------------------------

HOST_BOUNDARY = re.compile(r"\s*# repro: host-boundary.*$")


@pytest.mark.parametrize("rel", MARKED)
def test_every_host_boundary_annotation_guards(tmp_path, rel):
    """Stripping any one annotation of a marked module (one the line above
    does not cover already) turns the lint red, and stripping them all
    leaves findings in every marked module."""
    lines = open(os.path.join(PORT, rel)).read().split("\n")
    marked = [i for i, ln in enumerate(lines) if "# repro: host-boundary" in ln]
    assert marked
    covered = [i for i in marked if i - 1 in marked]
    copy = tmp_path / "stripped.py"
    for i in sorted(set(marked) - set(covered)):
        stripped = list(lines)
        stripped[i] = HOST_BOUNDARY.sub("", stripped[i])
        copy.write_text("\n".join(stripped))
        findings = ast_lint.lint_paths([str(copy)])
        assert [f.rule for f in findings if f.line in (i + 1, i + 2)], (rel, i + 1, lines[i])
        assert {f.rule for f in findings} == {"ast-host-sync-unannotated"}
    copy.write_text("\n".join(HOST_BOUNDARY.sub("", ln) for ln in lines))
    assert len(ast_lint.lint_paths([str(copy)])) >= len(marked)


@pytest.mark.parametrize("rel,bump", [
    ("kernels/cim_logic.py", 'LAUNCHES["cim"] += 1'),
    ("kernels/aig_sim.py", 'LAUNCHES["eval_mega"] += 1'),
    ("kernels/aig_sim.py", 'LAUNCHES["sig_eval"] += 1'),
])
def test_flip_removing_a_launch_counter(tmp_path, rel, bump):
    src = open(os.path.join(PORT, rel)).read()
    assert src.count(bump) == 1
    stripped = tmp_path / "stripped.py"
    stripped.write_text(src.replace(bump, "pass"))
    findings = ast_lint.lint_paths([str(stripped)])
    assert [f.rule for f in findings] == ["ast-launch-no-counter"]


def test_opt_outs_and_mappings_of_tables(tmp_path):
    p = tmp_path / "m.py"
    p.write_text(
        "# repro: kernel-module\n"
        "import torch\n"
        "from typing import Mapping\n\n"
        "def launch(lib):  # repro: no-launch-count\n"
        "    return lib.k1_sig_eval()\n\n"
        "def gather(grid):\n"
        "    return grid._raw('energy').cpu()  # repro: host-boundary\n\n"
        "def size(lib):\n"
        "    return lib.k2_shared_bytes(8)  # a size query, no launch\n\n"
        "def f(works: 'Mapping[str, WorkloadTable]'):\n"
        "    if not works:\n"
        "        raise ValueError('empty')\n"
    )
    assert ast_lint.lint_paths([str(p)]) == []


@pytest.mark.parametrize("wrap", [
    "@torch.compile\ndef step(x):\n    return x.tolist()\n",
    "@functools.partial(torch.compile, fullgraph=True)\ndef step(x):\n    return x.numpy()\n",
    "def step(x):\n    return float(x)\n\nfast = torch.compile(step)\n",
])
def test_every_compile_wrapper_is_found(tmp_path, wrap):
    p = tmp_path / "m.py"
    p.write_text("import functools\nimport torch\n\n" + wrap)
    assert [f.rule for f in ast_lint.lint_paths([str(p)])] == ["ast-host-sync-in-compile"]


def test_launch_entries_are_read_from_the_sources(tmp_path):
    assert ast_lint.launch_entries() == {"k1_eval_mega", "k1_sig_eval", "k2_cim"}
    cu = tmp_path / "k3.cu"
    cu.write_text('extern "C" int k3_go(const void* x) { return 0; }\n'
                  'extern "C" long k3_bytes(int n) { return n; }\n')
    assert ast_lint.launch_entries([str(cu)]) == {"k3_go"}  # a size query is no launch


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _port_specs():
    return [s for s in registry.kernel_specs() if s.module.startswith("repro_torch.")]


def test_the_registry_lists_the_kernels_and_counters():
    by_module = {}
    for s in _port_specs():
        by_module.setdefault(s.module, []).append(s.name)
    assert sorted(by_module["repro_torch.core.batch"]) == [
        "evaluate_grid", "evaluate_suite", "fused_grid", "fused_suite",
        "schedule_grid", "schedule_suite", "select_batch",
    ]
    assert sorted(by_module["repro_torch.kernels.aig_sim"]) == ["aig_eval", "aig_sig"]
    assert by_module["repro_torch.kernels.cim_logic"] == ["cim"]
    assert by_module["repro_torch.launch.system"] == ["roofline_sweep"]
    assert registry.KERNEL_OWNERS["eval_mega"] == "repro_torch.kernels.aig_sim"
    assert registry.KERNEL_OWNERS["sig_eval"] == "repro_torch.kernels.aig_sim"
    assert registry.KERNEL_OWNERS["cim"] == "repro_torch.kernels.cim_logic"
    launches = {s.name: s.launches for s in _port_specs() if s.launches}
    assert launches == {"aig_eval": ("eval_mega",), "aig_sig": ("sig_eval",), "cim": ("cim",)}
    assert not any(s.x64 for s in _port_specs() if s.launches)


def test_module_counters_are_views_of_the_one_counter():
    before = registry.launch_counts()
    try:
        K.LAUNCHES["cim"] += 1
        A.LAUNCHES["sig_eval"] += 2
        assert registry.LAUNCH_COUNTS["cim"] == before.get("cim", 0) + 1
        assert registry.launch_counts(module="repro_torch.kernels.aig_sim")["sig_eval"] == (
            before.get("sig_eval", 0) + 2)
        assert "cim" not in registry.launch_counts(module="repro_torch.kernels.aig_sim")
        assert dict(K.LAUNCHES) == {"cim": registry.LAUNCH_COUNTS["cim"]}
        assert set(A.LAUNCHES) == {"eval_mega", "sig_eval"} and K.LAUNCHES != {"cim": -1}
        with pytest.raises(TypeError):
            del K.LAUNCHES["cim"]
    finally:
        K.LAUNCHES["cim"] = before.get("cim", 0)
        A.LAUNCHES["sig_eval"] = before.get("sig_eval", 0)
    # the word-tier breakdown stays a plain dict of the module
    assert type(A.TIER_LAUNCHES) is dict and set(A.TIER_LAUNCHES) == {1, 32, 512}


def test_counter_ownership_conflict_rejected():
    with pytest.raises(ValueError, match="already registered"):
        registry.register_counter("cim", "some.other.module")
    with pytest.raises(ValueError, match="already registered"):
        registry.register_kernel("schedule_grid", "some.other.module", lambda d: None)


# ---------------------------------------------------------------------------
# the baseline and the CLI
# ---------------------------------------------------------------------------


def test_baseline_roundtrip_and_line_independence(tmp_path):
    f = Finding(rule="ast-truthy-table", severity="error", path="src/x.py", line=3,
                message="m", context="return model or DEFAULT")
    path = str(tmp_path / "baseline.json")
    write_baseline(path, [f])
    baseline = load_baseline(path)
    moved = dataclasses.replace(f, line=99)
    fresh = dataclasses.replace(f, rule="ast-launch-no-counter")
    new, old = split_baselined([moved, fresh], baseline)
    assert old == [moved] and new == [fresh]


def test_cli_write_baseline_then_green(tmp_path, capsys):
    target = ast_fixture(tmp_path, "ast-truthy-table")
    bl = str(tmp_path / "bl.json")
    assert lint.main(["--no-graph", "--baseline", bl, target]) == 1
    assert lint.main(["--no-graph", "--baseline", bl, "--write-baseline", target]) == 0
    capsys.readouterr()
    assert lint.main(["--no-graph", "--baseline", bl, target]) == 0
    assert "[baselined]" in capsys.readouterr().out
    assert lint.main(["--no-graph", "--baseline", "", "--write-baseline", target]) == 2


def test_cli_json_format(tmp_path, capsys):
    rc = lint.main(["--no-graph", "--baseline", "", "--format", "json",
                    ast_fixture(tmp_path, "ast-launch-no-counter")])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert set(payload) == {"new", "baselined", "counts"}
    assert payload["counts"] == {"new": 1, "baselined": 0, "total": 1}
    assert set(payload["new"][0]) == {"rule", "severity", "path", "line", "message", "context"}
    assert payload["new"][0]["rule"] == "ast-launch-no-counter"


# ---------------------------------------------------------------------------
# parity with the reference's analyzer
# ---------------------------------------------------------------------------


def test_baselines_cross_over_both_ways(tmp_path):
    fs = [Finding(rule=r, severity="error", path=p, line=i, message="m", context=c)
          for i, (r, p, c) in enumerate([
              ("ast-truthy-table", "src/a.py", "x or y"),
              ("graph-host-sync", "repro_torch.core.batch", "select_batch: aten.item"),
              ("ast-host-sync-unannotated", "src/b.py", ""),
          ])]
    ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    write_baseline(ours, fs)
    RF.write_baseline(theirs, [RF.Finding(**f.as_dict()) for f in fs])
    assert open(ours).read() == open(theirs).read()
    assert RF.load_baseline(ours) == load_baseline(theirs) == {f.key() for f in fs}


@pytest.mark.parametrize("name", ["fx_ast_truthy_table.py", "fx_ast_host_sync.py"])
def test_reference_fixtures_give_the_reference_findings(name):
    path = os.path.join(REF_FIXTURES, name)
    ours = [(f.rule, f.line) for f in ast_lint.lint_paths([path], root=REPO)]
    theirs = [(f.rule, f.line) for f in RAST.lint_paths([path], root=REPO)]
    assert ours == theirs and len(ours) == 1


def test_kernel_names_and_owners_match_the_reference():
    ref_names = {s.name for s in RREG.kernel_specs()}
    ours = {s.name for s in _port_specs()}
    # the port adds a builder under K2's counter name; the reference's K2
    # registers its counter only
    assert ours == ref_names | {"cim"}
    ref_owned = {k for k, m in RREG.KERNEL_OWNERS.items() if m.startswith("repro.")}
    port_owned = {k for k, m in registry.KERNEL_OWNERS.items() if m.startswith("repro_torch.")}
    mapped = set()
    for k in ref_owned:
        mapped.update(COUNTER_MAP.get(k, (k,)))
    assert port_owned == mapped | set(PORT_ONLY)
    for k, m in PORT_ONLY.items():
        assert registry.KERNEL_OWNERS[k] == m
    for k in ref_owned - set(COUNTER_MAP):
        assert registry.KERNEL_OWNERS[k] == RREG.KERNEL_OWNERS[k].replace("repro.", "repro_torch.", 1)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_select_best_batch_device_keeps_operands_on_their_device():
    rng = np.random.default_rng(7)
    host_energy = rng.random((4, 96))
    host_fits = np.ones((1, 96), dtype=bool)
    energy = torch.from_numpy(host_energy)
    fits = torch.from_numpy(host_fits)
    with _Ops() as rec:
        idx = B.select_best_batch_device(energy, fits, device=CPU)
    assert "aten._to_copy.default" not in rec.ops
    assert "aten._local_scalar_dense.default" not in rec.ops
    np.testing.assert_array_equal(idx, RB.select_best_batch(host_energy, host_fits))
    # an all-non-finite cell still raises, from the one winner payload
    energy[1] = float("nan")
    with pytest.raises(ValueError, match="no finite energies"):
        B.select_best_batch_device(energy, fits, device=CPU)
