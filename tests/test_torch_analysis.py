"""repro_torch.analysis: the port's static analyzer.

A bad and a good fixture for each rule (the PIPE rules' are the
reference's own, from tests/test_analysis.py), two of them taken from the
port's history: a kernel wrapper whose CUDA route returned ctypes-filled
outputs under autograd (a silent fault: the attention weights never
trained), and a rank-guarded collective.  Then the kernel-signature rule on
a SIGNATURES entry one argtype short of its prototype, the suppression
syntax, --select and --ignore and the CLI's exit codes; the PIPE rules held
against the JAX package's analyzer, finding for finding, on its fixtures and
on every file of both packages; and the port's own tree, which has no
unsuppressed finding.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
from test_analysis import FIXTURES as REF_FIXTURES

from repro.analysis import analyze_paths as ref_analyze_paths
from repro.analysis import analyze_source as ref_analyze_source
from repro.analysis import select_rules as ref_select_rules
from repro_torch.analysis import (all_rules, analyze_paths, analyze_source,
                                  parse_suppressions, select_rules)

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
PIPE = ("PIPE301", "PIPE301C", "PIPE302", "PIPE303")
# the tick's modules, where the host-sync rule applies
ENGINE = "src/repro_torch/serving/engine.py"
KERNEL = "src/repro_torch/kernels/flash_attention.py"


def dedent(s: str) -> str:
    return textwrap.dedent(s).lstrip()


def hits(source: str, rule_id: str, path: str = "<string>"):
    return [f for f in analyze_source(dedent(source), path)
            if f.rule == rule_id and not f.suppressed]


# ---------------------------------------------------------------------------
# fixture pairs: rule id -> (bad snippet, good snippet, path it is read at)
# ---------------------------------------------------------------------------

# the wrapper's shape when its CUDA route dropped the gradient: under
# autograd it returned the forward kernel's outputs, which carry no grad_fn
FROZEN_WRAPPER = """
    from repro_torch.kernels import build

    def _launch_forward(q, k, v):
        lib = build.library("flash_attention")
        out = torch.empty_like(q)
        lib.flash_attention_launch(q.data_ptr(), k.data_ptr(),
                                   v.data_ptr(), out.data_ptr())
        return out

    def flash_attention(q, k, v):
        if build.route(q, "flash attention") == "plain":
            return flash_attention_plain(q, k, v)
        return _launch_forward(q, k, v)
    """

ROUTED_WRAPPER = """
    import torch
    from repro_torch.kernels import build

    def _launch_forward(q, k, v):
        out = torch.empty_like(q)
        build.library("flash_attention").flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        return out

    class FlashAttentionFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            return _launch_forward(q, k, v)

    def flash_attention(q, k, v):
        if build.route(q, "flash attention") == "plain":
            return flash_attention_plain(q, k, v)
        grad = build.needs_grad(q, k, v)
        if grad:
            return FlashAttentionFn.apply(q, k, v)
        return _launch_forward(q, k, v)

    def decode_attention(q, kc, vc):
        build.refuse_grad("decode_attention", q, kc, vc)
        out = torch.empty_like(q)
        build.library("decode").decode_attention_launch(out.data_ptr())
        return out
    """

FIXTURES = {
    "CUDA101": (
        """
        from repro_torch.parallel import comm

        def emit(out, S):
            if comm.axis_index("stage") == S - 1:
                out = comm.psum(out, "stage")
            return out
        """,
        """
        from repro_torch.parallel import comm

        def emit(out, S):
            last = comm.axis_index("stage") == S - 1
            return comm.psum(comm.where(last, out, out * 0), "stage")
        """, "<string>"),
    "CUDA102": (
        """
        def decode_step(self, tok):
            nxt = self._fused.step(self.caches, tok)
            ids = nxt.cpu()
            n = int(torch.count_nonzero(nxt))
            return ids, n
        """,
        """
        def decode_step(self, tok, pos0):
            nxt = self._fused.step(self.caches, tok)
            # repro: noqa[CUDA102] -- THE per-tick sync: B int32 ids
            ids = nxt.cpu()
            return ids, int(pos0), len(tok.shape)
        """, ENGINE),
    "CUDA103": (
        """
        from repro_torch.kernels import build

        def run_all(names, xs):
            for name, x in zip(names, xs):
                lib = build.library(name)
                prog = StageDecodeProgram(cfg, 0, 2)
                prog(x)
        """,
        """
        import functools
        from repro_torch.kernels import build

        @functools.lru_cache(maxsize=None)
        def program(lo, hi):
            return StageDecodeProgram(cfg, lo, hi)

        def run_all(self, xs):
            lib = build.library("decode_attention")
            for x in xs:
                prog = self._lookup(("d", 0), lambda: StageDecodeProgram(
                    cfg, 0, 2))
                program(0, 2)(x)
        """, "<string>"),
    "CUDA105": (
        """
        import torch

        def tick(self, table, steps):
            for t in range(steps):
                tables = torch.from_numpy(table).to(self.device)
                tok = torch.tensor(self.start, device=self.device)
                self.step(tables, tok, t)
        """,
        """
        import torch

        def tick(self, table, steps, leaves):
            tables = torch.from_numpy(table).to(self.device)
            idx = None
            for t in range(steps):
                pos = torch.tensor([t], device=self.device)
                self.step(tables, pos.to(self.device))
            for leaf in leaves:
                if idx is None:
                    idx = torch.from_numpy(table).to(leaf.device)
                leaf[idx] = 0
        """, "<string>"),
    "KER206": (FROZEN_WRAPPER, ROUTED_WRAPPER, KERNEL),
}
# the signature rule reads kernels/csrc beside the module: its fixture is
# written to disk (_signature_tree)
SIG_PROTO = """
// a kernel's C interface
extern "C" int scale_launch(const void* x, void* out, int n, float alpha,
                            void* stream) {
  return 0;
}
"""
SIG_GOOD = """
import ctypes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "scale": {
        "scale_launch": [_P, _P, _I, _F, _P],
    },
}
"""
SIG_BAD = SIG_GOOD.replace("[_P, _P, _I, _F, _P]", "[_P, _P, _I, _P]")


def _signature_tree(root: Path, build_source: str) -> Path:
    kernels = root / "kernels"
    (kernels / "csrc").mkdir(parents=True, exist_ok=True)
    (kernels / "csrc" / "scale.cu").write_text(SIG_PROTO)
    (kernels / "build.py").write_text(build_source)
    return kernels / "build.py"


def _fixture(rule_id):
    """(bad source, good source, path) for every rule; the PIPE rules' are
    the reference's."""
    if rule_id in FIXTURES:
        return FIXTURES[rule_id]
    bad, good = REF_FIXTURES[rule_id]
    return bad, good, "<string>"


PORT_RULES = sorted(set(FIXTURES) | set(PIPE))


def test_every_rule_has_fixtures():
    assert {r.id for r in all_rules()} == set(PORT_RULES) | {"KER203"}, \
        "every registered rule needs a bad/good fixture pair here"


@pytest.mark.parametrize("rule_id", PORT_RULES)
def test_bad_fixture_triggers(rule_id):
    bad, _, path = _fixture(rule_id)
    assert hits(bad, rule_id, path), f"{rule_id} missed its bad fixture"


@pytest.mark.parametrize("rule_id", PORT_RULES)
def test_good_fixture_is_clean(rule_id):
    _, good, path = _fixture(rule_id)
    assert not hits(good, rule_id, path), \
        f"{rule_id} flagged its good fixture"


# ---------------------------------------------------------------------------
# the rules' edges
# ---------------------------------------------------------------------------

def test_grad_bypass_flags_the_frozen_attention_wrapper():
    """The wrapper that returned a launch's outputs under autograd is
    flagged at its def; its _launch_* helper is not (it is what a wrapper
    routes to); outside kernels/ the rule does not apply."""
    got = hits(FROZEN_WRAPPER, "KER206", KERNEL)
    assert [f.message.split("`")[1] for f in got] == ["flash_attention"]
    assert got[0].line == dedent(FROZEN_WRAPPER).splitlines().index(
        "def flash_attention(q, k, v):") + 1
    assert not hits(FROZEN_WRAPPER, "KER206", "src/repro_torch/models/x.py")


def test_grad_bypass_route_must_reach_a_function():
    """A needs_grad test whose branch applies no autograd.Function is no
    route; a helper that launches makes its caller a wrapper."""
    src = FROZEN_WRAPPER + """
    def attention(q, k, v):
        if build.needs_grad(q, k, v):
            raise ValueError("no")
        return flash_attention(q, k, v)
    """
    names = [f.message.split("`")[1] for f in hits(src, "KER206", KERNEL)]
    assert names == ["flash_attention", "attention"]


@pytest.mark.parametrize("snippet", [
    """
    def emit(out):
        if comm.axis_index("stage") == 0:
            return comm.psum(out, "stage")
        return out
    """,
    """
    def emit(out):
        stage = comm.axis_index("stage")
        last = stage == 3
        return comm.all_gather(out, "stage") if last else out
    """,
    """
    def emit(out):
        if dist.get_rank() == 0:
            dist.barrier()
    """,
    """
    def _reduce(x):
        return comm.psum(x, "tensor")

    def emit(out, rank):
        while rank > 0:
            out = _reduce(out)
            rank -= 1
        return out
    """,
    """
    def emit(out):
        stage = comm.axis_index("stage")

        def tick(x):
            if stage == 0:
                x = comm.ppermute(x, "stage", [(0, 1)])
            return x
        return tick(out)
    """])
def test_rank_branch_flags_guarded_collectives(snippet):
    """A rank-guarded collective, by a direct read of the rank, a name
    derived from it, a rank parameter, a module function one call away, or
    a closure over the rank; the hint names comm.where."""
    got = hits(snippet, "CUDA101")
    assert len(got) == 1
    assert "comm.where" in select_rules(["CUDA101"])[0].hint


def test_rank_branch_equal_branches_and_other_tests_pass():
    src = """
    def emit(out, n):
        if comm.axis_index("stage") == 0:
            out = comm.psum(out * 2, "stage")
        else:
            out = comm.psum(out, "stage")
        if n > 1:
            out = comm.psum(out, "stage")
        owner = comm.axis_index("seq") == 1
        if owner:
            out[0] = 0
        return out
    """
    assert not hits(src, "CUDA101")


def test_host_sync_scope_and_provenance():
    """Only the tick's modules; a tensor is known by where it came from
    (a parameter is not), and one sync is flagged once."""
    src = """
    import numpy as np

    def tick(self, x, pos0):
        y = torch.softmax(x, -1)
        z = y.sum(0) + 1
        a = np.asarray(z)
        b = float(z)
        c = z.item()
        d = y.cpu().numpy()
        e = int(pos0) + len(x.shape) + int(z.shape[0])
        torch.cuda.synchronize()
        return a, b, c, d, e
    """
    got = [f.message.split("`")[1] for f in hits(src, "CUDA102", ENGINE)]
    assert got == ["np.asarray", "float()", ".item()", ".cpu()",
                   "torch.cuda.synchronize()"]
    layer = "src/repro_torch/models/layers.py"
    assert len(hits(src, "CUDA102", layer)) == 5
    assert not hits(src, "CUDA102", "src/repro_torch/launch/serve.py")


def test_loop_invariant_transfer_forms():
    src = """
    def f(self, xs, arr):
        for x in xs:
            a = x.to(self.device)
            b = arr.cuda()
            c = arr.to(torch.float32)
            d = self.table.to("cuda")
        while True:
            e = torch.as_tensor(arr, device="cuda")
    """
    got = sorted(f.line for f in hits(src, "CUDA105"))
    assert got == [4, 6, 8]


def test_build_in_loop_forms():
    src = """
    def f(self, ks):
        for k in ks:
            g = torch.cuda.CUDAGraph()
            fn = torch.compile(self.step)
            self.cache[k] = lambda: FusedDecodeProgram(cfg, k)
        while ks:
            build.load_all()
    """
    assert sorted(f.line for f in hits(src, "CUDA103")) == [3, 4, 7]


def test_launch_signature_one_argtype_short(tmp_path):
    """A SIGNATURES entry one argtype short of its extern "C" prototype is
    flagged (at the entry); a parameter of another kind too; the stream
    takes c_void_p; the good entry is clean."""
    good = _signature_tree(tmp_path / "good", SIG_GOOD)
    assert not [f for f in analyze_paths([str(good)]).findings]
    bad = _signature_tree(tmp_path / "bad", SIG_BAD)
    got = analyze_paths([str(bad)]).findings
    assert [f.rule for f in got] == ["KER203"]
    assert "4 argtypes, but scale.cu declares 5" in got[0].message
    assert got[0].line == SIG_BAD.splitlines().index(
        '        "scale_launch": [_P, _P, _I, _P],') + 1
    kind = _signature_tree(tmp_path / "kind", SIG_GOOD.replace(
        "[_P, _P, _I, _F, _P]", "[_P, _P, _F, _F, _P]"))
    got = analyze_paths([str(kind)]).findings
    assert len(got) == 1 and "`int n` (int)" in got[0].message
    missing = _signature_tree(tmp_path / "missing", SIG_GOOD.replace(
        '"scale_launch"', '"shift_launch"'))
    got = analyze_paths([str(missing)]).findings
    assert len(got) == 1 and "no extern" in got[0].message


def test_launch_signature_holds_the_port_build():
    """Every entry of kernels/build.py matches its .cu prototype (the flash
    backward's took a dtype code in this slice)."""
    report = analyze_paths([str(SRC / "repro_torch" / "kernels" /
                                "build.py")], select=["KER203"])
    assert report.files_scanned == 1 and report.findings == []


# ---------------------------------------------------------------------------
# suppression, --select / --ignore
# ---------------------------------------------------------------------------

BAD_SYNC = """
def decode_step(self, nxt):
    return nxt.cpu(){noqa}
"""


def _sync_findings(noqa: str):
    return [f for f in analyze_source(BAD_SYNC.format(noqa=noqa), ENGINE)
            if f.rule == "CUDA102"]


@pytest.mark.parametrize("noqa,suppressed,why", [
    ("", False, ""),
    ("  # repro: noqa[CUDA102] -- the tick's one sync", True,
     "the tick's one sync"),
    ("  # repro: noqa[CUDA105]", False, ""),
    ("  # repro: noqa", True, ""),
    ("  # repro: noqa[CUDA105, CUDA102]", True, "")])
def test_noqa(noqa, suppressed, why):
    (f,) = _sync_findings(noqa)
    assert f.suppressed == suppressed and f.justification == why


def test_noqa_on_the_line_above_and_same_syntax_as_reference():
    src = ("def decode_step(self, nxt):\n"
           "    # repro: noqa[CUDA102] -- the tick's one sync\n"
           "\n"
           "    return nxt.cpu()\n")
    (f,) = [f for f in analyze_source(src, ENGINE) if f.rule == "CUDA102"]
    assert f.suppressed and f.justification == "the tick's one sync"
    from repro.analysis import parse_suppressions as ref_parse

    def plain(sups):
        return {k: (s.line, s.rules, s.justification)
                for k, s in sups.items()}
    assert plain(parse_suppressions(src)) == plain(ref_parse(src))


def test_select_and_ignore():
    assert [r.id for r in select_rules(["CUDA102", "grad-bypass"])] == \
        ["CUDA102", "KER206"]
    assert "CUDA102" not in {r.id for r in select_rules(ignore=["host-sync"])}
    src = dedent(FIXTURES["CUDA102"][0])
    got = analyze_source(src, ENGINE, select_rules(ignore=["CUDA102"]))
    assert not [f for f in got if f.rule == "CUDA102"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_exit_codes_and_formats(tmp_path, capsys):
    """1 with --fail-on-findings and a finding, else 0; 2 for an unknown
    rule; JSON and a report file; --list-rules; --select and --ignore."""
    from repro_torch.analysis.cli import main
    bad = tmp_path / "serving" / "engine.py"
    bad.parent.mkdir()
    bad.write_text(BAD_SYNC.format(noqa=""))
    capsys.readouterr()
    assert main([str(bad), "--format", "json", "--fail-on-findings"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["n_findings"] == 1
    assert payload["findings"][0]["rule"] == "CUDA102"
    report = tmp_path / "report.json"
    assert main([str(bad), "--ignore", "CUDA102", "--report", str(report),
                 "--fail-on-findings"]) == 0
    assert json.loads(report.read_text())["n_findings"] == 0
    assert main([str(bad), "--select", "KER206", "--fail-on-findings"]) == 0
    assert main([str(bad)]) == 0                 # reports, does not fail
    assert main(["--select", "NOPE999"]) == 2
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(rid in listed for rid in PORT_RULES + ["KER203"])


def test_cli_module_on_the_default_path():
    """``python -m repro_torch.analysis`` scans src/repro_torch by default
    and ends clean, showing each suppression with its justification."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--fail-on-findings", "--show-suppressed"],
                       capture_output=True, text=True, env=env,
                       cwd=str(REPO), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "(suppressed: THE per-tick sync" in r.stdout
    assert " 0 finding(s)" in r.stdout


# ---------------------------------------------------------------------------
# the PIPE rules against the JAX package's analyzer
# ---------------------------------------------------------------------------

def _pipe(findings):
    return sorted((f.rule, f.line, f.suppressed) for f in findings
                  if f.rule in PIPE)


@pytest.mark.parametrize("rule_id", PIPE)
def test_pipe_rules_equal_reference_on_its_fixtures(rule_id):
    for src in REF_FIXTURES[rule_id]:
        src = dedent(src)
        mine = _pipe(analyze_source(src, "<string>",
                                    select_rules(PIPE)))
        ref = _pipe(ref_analyze_source(src, "<string>",
                                       ref_select_rules(PIPE)))
        assert mine == ref


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_pipe_rules_equal_reference_on_both_packages(tree):
    mine = analyze_paths([str(SRC / tree)], select=PIPE)
    ref = ref_analyze_paths([str(SRC / tree)], select=PIPE)
    assert mine.files_scanned == ref.files_scanned > 50

    def key(r):
        return sorted((f.path, f.rule, f.line, f.suppressed)
                      for f in r.findings + r.suppressed)
    assert key(mine) == key(ref)


def test_analyzer_runs_clean_on_src_repro_torch():
    """The port has no unsuppressed finding, and every suppression
    carries a justification."""
    report = analyze_paths([str(SRC / "repro_torch")])
    assert report.files_scanned > 50 and not report.parse_errors
    assert report.findings == [], [f.format_text() for f in report.findings]
    assert report.suppressed
    for f in report.suppressed:
        assert f.justification, f.location()
