"""The port's pre-run analyzers (``repro_torch.analysis``) beside the JAX
package's: the twin of ``tests/test_analysis.py``.

Every seeded-defect YAML fixture goes through both analyzers, which must
give the same (code, severity, line, task, port) list; the lint fixtures
and the port's ``core/`` lint the same in both; the runtime fixtures run
against the port with their ``repro.`` imports pointed at ``repro_torch.``
(the fixture files stay as they are).  Each reference case has a twin of
the same name here.  By design:

* ``test_core_tree_lints_clean`` lints ``src/repro_torch/core`` (the
  port's own core) with both packages' lint, not ``src/repro``;
* ``test_example_workflows_are_clean`` checks the port's examples
  (``examples/torch_*.py``), which import no JAX, with both analyzers;
* ``test_cli_lint_subcommand`` also runs ``lint`` with no path, which
  lints the port's core.
"""

import glob
import json
import os
import re
import threading

import pytest

from repro.analysis import astlint as jastlint
from repro.analysis import workflow as jworkflow
from repro_torch.analysis import astlint, lockcheck, rules, workflow
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.diagnostics import (Diagnostic, Findings, Location,
                                              REGISTRY, Severity,
                                              line_suppressions)
from repro_torch.analysis.rules import WorkflowValidationError

HERE = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(HERE, "analysis_fixtures")
REPO = os.path.dirname(HERE)
SRC_TREE = os.path.join(REPO, "src", "repro_torch")
CORE_TREE = os.path.join(SRC_TREE, "core")
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "torch_*.py")))

_FIX_RE = re.compile(r"wlk(\d+)")


def _fixture_code(path):
    return "WLK" + _FIX_RE.match(os.path.basename(path)).group(1)


def _fixtures(pattern):
    return sorted(glob.glob(os.path.join(FIXDIR, pattern)))


def _expectations(path):
    with open(path) as f:
        first = f.readline()
    out = {}
    m = re.search(r"#\s*expect:(.*)", first)
    if m:
        for kv in m.group(1).split():
            k, _, v = kv.partition("=")
            out[k] = v
    return out


def _load_trigger(path):
    """The fixture's ``trigger`` with its ``repro.`` imports pointed at the
    port: the same seeded defect, run through ``repro_torch``."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"\bfrom repro\.", "from repro_torch.", text)
    text = re.sub(r"\bimport repro\.", "import repro_torch.", text)
    ns = {"__name__": "_torch_fixture_" + os.path.basename(path)[:-3]}
    exec(compile(text, path, "exec"), ns)
    return ns["trigger"]


def _rows(findings):
    return [(d.code, d.severity, d.location.line, d.location.task,
             d.location.port) for d in findings]


# ---------------------------------------------------------------------------
# registry completeness
# ---------------------------------------------------------------------------
def _all_fixtures():
    return (_fixtures("wlk*.yaml")
            + _fixtures(os.path.join("lint", "wlk*.py"))
            + _fixtures(os.path.join("runtime", "wlk*.py"))
            + _fixtures(os.path.join("races", "wlk*.py")))


def test_every_registry_code_has_a_fixture():
    from repro.analysis.diagnostics import REGISTRY as JREGISTRY
    assert REGISTRY == JREGISTRY          # the same codes and severities
    seeded = {_fixture_code(p) for p in _all_fixtures()}
    missing = sorted(set(REGISTRY) - seeded)
    assert not missing, f"registry codes without a seeded fixture: {missing}"


def test_every_fixture_names_a_registry_code():
    for p in _all_fixtures():
        assert _fixture_code(p) in REGISTRY, p


# ---------------------------------------------------------------------------
# pass 1: workflow-analyzer fixtures, both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", _fixtures("wlk*.yaml"),
                         ids=lambda p: os.path.basename(p))
def test_yaml_fixture_flags_its_code(path):
    code = _fixture_code(path)
    findings = workflow.analyze_file(path)
    assert _rows(findings) == _rows(jworkflow.analyze_file(path))
    hits = [d for d in findings if d.code == code]
    assert hits, (f"{os.path.basename(path)} expected {code}, got "
                  f"{[d.code for d in findings]}")
    d = hits[0]
    assert d.severity == REGISTRY[code][0]
    assert d.location.file == path
    expect = _expectations(path)
    if "task" in expect:
        assert d.location.task == expect["task"], d.render()
    if "port" in expect:
        assert d.location.port == expect["port"], d.render()
    if code not in ("WLK002",):
        assert d.location.line is not None, d.render()


MULTI = """
tasks:
  - func: sim
    outports:
      - filename: data.h5
        prefetch: 2
  - func: viz
    inports:
      - filename: data.h5
        queue_depth: 0
      - filename: aux.h5
        weight: 0
"""


def test_analyzer_collects_multiple_violations_in_one_pass():
    codes = sorted(d.code for d in workflow.analyze_source(MULTI))
    assert codes == ["WLK101", "WLK105", "WLK108"]
    assert _rows(workflow.analyze_source(MULTI)) == \
        _rows(jworkflow.analyze_source(MULTI))


def test_analyzer_matches_graph_first_error_message():
    import yaml as _yaml
    from repro_torch.core.graph import WorkflowGraph
    text = """
tasks:
  - func: viz
    inports:
      - filename: data.h5
        io_freq: -3
"""
    with pytest.raises(ValueError) as ei:
        WorkflowGraph.from_yaml(_yaml.safe_load(text))
    (d,) = list(workflow.analyze_source(text))
    assert d.code == "WLK102"
    assert d.message == str(ei.value)
    (jd,) = list(jworkflow.analyze_source(text))
    assert jd.message == d.message


# ---------------------------------------------------------------------------
# pass 2 (static half): AST-lint fixtures, both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", _fixtures(os.path.join("lint", "wlk*.py")),
                         ids=lambda p: os.path.basename(p))
def test_lint_fixture_flags_its_code(path):
    code = _fixture_code(path)
    findings = astlint.lint_file(path)
    assert _rows(findings) == _rows(jastlint.lint_file(path))
    hits = [d for d in findings if d.code == code]
    assert hits, (f"{os.path.basename(path)} expected {code}, got "
                  f"{[d.code for d in findings]}")
    assert hits[0].location.file == path
    assert hits[0].location.line is not None


# ---------------------------------------------------------------------------
# pass 2 (runtime half) + programmatic rules, on the port
# ---------------------------------------------------------------------------
@pytest.fixture
def lockcheck_on(monkeypatch):
    monkeypatch.setenv("WILKINS_LOCKCHECK", "1")
    lockcheck.registry().reset()
    yield lockcheck.registry()
    lockcheck.registry().reset()


def test_wlk118_fixture_rejects_bad_rescale_request():
    trigger = _load_trigger(
        os.path.join(FIXDIR, "runtime", "wlk118_rescale_request.py"))
    with pytest.raises(WorkflowValidationError) as ei:
        trigger()
    assert ei.value.code == "WLK118"


@pytest.mark.parametrize("name,code", [
    ("wlk310_lock_cycle.py", "WLK310"),
    ("wlk311_blocking_under_lock.py", "WLK311"),
    ("wlk312_rank_inversion.py", "WLK312"),
])
def test_runtime_fixture_records_its_code(lockcheck_on, name, code):
    _load_trigger(os.path.join(FIXDIR, "runtime", name))()
    codes = {d.code for d in lockcheck_on.findings()}
    assert code in codes, f"{name} expected {code}, recorded {codes}"


def test_lockcheck_clean_nesting_records_no_findings(lockcheck_on):
    serve = lockcheck.CheckedLock("vol.serve:sim[0]")
    sup = lockcheck.CheckedLock("supervisor:run")
    cv = lockcheck.CheckedCondition("channel.cv:data.h5")
    with serve:
        with sup:
            with cv:
                pass
    assert len(lockcheck_on.findings()) == 0
    lockcheck_on.assert_clean()


def test_lockcheck_wait_releases_held_entry(lockcheck_on):
    cv = lockcheck.CheckedCondition("channel.cv:data.h5")
    with cv:
        assert lockcheck_on.held() == ["channel.cv:data.h5"]
        cv.wait(timeout=0.01)
        assert lockcheck_on.held() == ["channel.cv:data.h5"]
    assert lockcheck_on.held() == []


def test_lockcheck_reentrant_same_object_is_not_a_violation(lockcheck_on):
    cv = lockcheck.CheckedCondition("channel.cv:data.h5")
    with cv:
        with cv:
            pass
    assert len(lockcheck_on.findings()) == 0


def test_make_lock_returns_plain_primitives_when_disabled(monkeypatch):
    monkeypatch.delenv("WILKINS_LOCKCHECK", raising=False)
    assert isinstance(lockcheck.make_lock("leaf:x"), type(threading.Lock()))
    assert isinstance(lockcheck.make_condition("leaf:x"),
                      threading.Condition)


# ---------------------------------------------------------------------------
# zero findings over the shipped tree: the port's examples + core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", EXAMPLES,
                         ids=lambda p: os.path.basename(p))
def test_example_workflows_are_clean(path):
    findings = workflow.analyze_file(path)
    assert len(findings) == 0, "\n" + findings.render_text()
    assert len(jworkflow.analyze_file(path)) == 0


def test_examples_embed_workflows():
    assert sum(len(workflow.load_workflows(p)) for p in EXAMPLES) >= 7


def test_core_tree_lints_clean():
    findings = astlint.lint_paths([CORE_TREE])
    assert len(findings) == 0, "\n" + findings.render_text()
    assert _rows(jastlint.lint_paths([CORE_TREE])) == _rows(findings)
    # the whole port lints the same in both packages
    assert _rows(astlint.lint_paths([SRC_TREE])) == \
        _rows(jastlint.lint_paths([SRC_TREE]))


# ---------------------------------------------------------------------------
# diagnostics plumbing: suppressions, renderers, CLI
# ---------------------------------------------------------------------------
def test_line_suppression_comment():
    text = """
tasks:
  - func: sim
    outports:
      - filename: data.h5
  - func: viz
    inports:
      - filename: data.h5
        queue_depth: 0   # wilkins: ignore[WLK101]
"""
    assert len(workflow.analyze_source(text)) == 0


def test_line_suppression_bare_ignores_all_codes():
    sup = line_suppressions("x: 1  # wilkins: ignore\n")
    assert sup == {1: None}


def test_line_suppression_only_covers_its_line_and_codes():
    text = """
tasks:
  - func: sim
    outports:
      - filename: data.h5
  - func: viz
    inports:
      - filename: data.h5
        queue_depth: 0   # wilkins: ignore[WLK999]
"""
    assert [d.code for d in workflow.analyze_source(text)] == ["WLK101"]
    assert _rows(workflow.analyze_source(text)) == \
        _rows(jworkflow.analyze_source(text))


def test_doc_level_suppression():
    text = """
lint:
  ignore: [WLK204]
tasks:
  - func: viz
    inports:
      - filename: ghost.h5
"""
    assert len(workflow.analyze_source(text)) == 0


def test_render_json_shape():
    f = Findings([Diagnostic("WLK101", "boom",
                             Location(file="w.yaml", line=3, task="viz",
                                      port="data.h5"))])
    doc = json.loads(f.render_json())
    assert doc["counts"] == {"total": 1, "error": 1, "warning": 0, "info": 0}
    (d,) = doc["findings"]
    assert d["code"] == "WLK101"
    assert d["severity"] == Severity.ERROR
    assert d["location"] == {"file": "w.yaml", "line": 3, "task": "viz",
                             "port": "data.h5"}


def test_render_text_sorts_errors_first():
    f = Findings([Diagnostic("WLK224", "info finding"),
                  Diagnostic("WLK101", "error finding")])
    lines = f.render_text().splitlines()
    assert "WLK101" in lines[0]
    assert lines[-1] == "2 finding(s), 1 error(s)"


def test_cli_check_exit_codes(capsys):
    bad = os.path.join(FIXDIR, "wlk101_queue_depth.yaml")
    assert cli_main(["check", bad]) == 1
    assert "WLK101" in capsys.readouterr().out
    assert cli_main(["check", EXAMPLES[0]]) == 0


def test_cli_strict_promotes_warnings(capsys):
    warn = os.path.join(FIXDIR, "wlk204_unmatched_inport.yaml")
    assert cli_main(["check", warn]) == 0
    assert cli_main(["check", "--strict", warn]) == 1
    capsys.readouterr()


def test_cli_json_output(capsys):
    bad = os.path.join(FIXDIR, "wlk101_queue_depth.yaml")
    assert cli_main(["check", "--json", bad]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"]["error"] == 1


def test_cli_lint_subcommand(capsys):
    fixture = os.path.join(FIXDIR, "lint", "wlk302_if_guarded_wait.py")
    assert cli_main(["lint", fixture]) == 1
    assert "WLK302" in capsys.readouterr().out
    assert cli_main(["lint", CORE_TREE]) == 0
    assert cli_main(["lint"]) == 0           # no path: the port's core
    assert "no findings" in capsys.readouterr().out
    assert cli_main(["explore", "--list"]) == 0    # the explorer is there
    assert "cow_share" in capsys.readouterr().out


def test_cli_codes_lists_registry(capsys):
    assert cli_main(["codes"]) == 0
    out = capsys.readouterr().out
    for code in REGISTRY:
        assert code in out


# ---------------------------------------------------------------------------
# dedup: graph/driver delegate to the shared rules
# ---------------------------------------------------------------------------
def test_graph_errors_carry_diagnostic_codes():
    import yaml as _yaml
    from repro_torch.core.graph import WorkflowGraph
    text = """
tasks:
  - func: viz
    inports:
      - filename: data.h5
        weight: 0
"""
    with pytest.raises(WorkflowValidationError) as ei:
        WorkflowGraph.from_yaml(_yaml.safe_load(text))
    assert ei.value.code == "WLK105"
    assert ei.value.task == "viz"
    assert ei.value.port == "data.h5"


def test_driver_rescale_request_uses_shared_rules():
    from repro_torch.core.graph import WorkflowGraph
    import yaml as _yaml
    g = WorkflowGraph.from_yaml(_yaml.safe_load("""
tasks:
  - func: sim
    outports:
      - filename: data.h5
  - func: viz
    inports:
      - filename: data.h5
"""))
    with pytest.raises(WorkflowValidationError) as ei:
        rules.validate_rescale_request(g, "viz")
    assert ei.value.code == "WLK118"
    rules.validate_rescale_request(g, "viz", nslots=2)
