"""Tests for ``python -m repro_torch check``, the port's contract analyzer.

Three parts:

* the differential test: each of the reference's fixture trees under
  ``tests/fixtures/analysis/`` is copied, renamed to ``repro_torch``, and
  analyzed by the port's rule with the contracts the reference's own test
  passes; the reference's rule runs on the original tree, and the findings
  must agree field for field after renaming;
* the reference's ``tests/test_analysis.py``, ported against the torch twins
  under ``tests/fixtures/torch/analysis/`` (parsed, never imported, never on
  ``sys.path``), plus the two adaptations of the port: torch's constructors
  and int32 narrowings in ``dtype-safety``, and an import search that starts
  at a module's package ancestors;
* the lock that the port's own tree is clean, with one waived finding.
"""

import json
import os
import re
import shutil
from functools import lru_cache

import pytest

from repro import analysis as ref
from repro.analysis.cli import DEFAULT_BASELINE as REF_BASELINE
from repro_torch import analysis as port
from repro_torch.analysis import (AnalysisContext, AtomicWriteRule,
                                  DtypeSafetyRule, ImportContract,
                                  ImportPurityRule, RegistryConformanceRule,
                                  SchemaDriftRule, default_root,
                                  default_rules, load_baseline, run_check,
                                  update_schema_manifest, write_baseline)
from repro_torch.analysis.cli import DEFAULT_BASELINE
from repro_torch.analysis.cli import main as check_main

HERE = os.path.dirname(os.path.abspath(__file__))
REF_FIXTURES = os.path.join(HERE, "fixtures", "analysis")
FIXTURES = os.path.join(HERE, "fixtures", "torch", "analysis")


def fx(name: str) -> str:
    return os.path.join(FIXTURES, name)


def fixture_ctx(name: str) -> AnalysisContext:
    return AnalysisContext(fx(name))


# ---------------------------------------------------------------------------
# the differential test against the reference's rules
# ---------------------------------------------------------------------------

#: the port's only change of wording besides the package name: its planning
#: paths stay free of torch where the reference's stay free of jax
PORT_WORDING = {"jax-free": "torch-free"}


def to_port_text(text: str) -> str:
    text = re.sub(r"\brepro\b", "repro_torch", text)
    for old, new in PORT_WORDING.items():
        text = text.replace(old, new)
    return text


def fields(finding) -> tuple:
    return (finding.rule, finding.path, finding.line, finding.message,
            finding.remediation)


def to_port(finding) -> tuple:
    """A reference finding's fields, renamed to the port."""
    return (finding.rule, to_port_text(finding.path), finding.line,
            to_port_text(finding.message), to_port_text(finding.remediation))


def renamed_tree(src: str, dst: str, old: str, new: str) -> str:
    """Copy the fixture tree ``src`` to ``dst`` with its package directory
    ``old/`` renamed to ``new/`` and ``old.`` rewritten to ``new.`` in the
    sources; returns ``dst``."""
    shutil.copytree(os.path.join(src, old), os.path.join(dst, new))
    for dirpath, _, filenames in os.walk(dst):
        for fn in filenames:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    text = f.read()
                with open(path, "w") as f:
                    f.write(re.sub(rf"\b{old}\.", f"{new}.", text))
    return dst


def rule_of(an, pkg: str, kind: str):
    """The rule that ``tests/test_analysis.py`` runs on a tree, built from
    the analysis package ``an`` for the package named ``pkg``."""
    if kind == "workloads":
        return an.ImportPurityRule(contracts=(an.ImportContract(
            f"{pkg}.workloads", ("jax", "numpy"), recursive=True),))
    if kind in ("compose", "compose_exempt"):
        exempt = ((f"{pkg}.compose.jax_engine", f"{pkg}.compose.executor")
                  if kind == "compose_exempt" else ())
        return an.ImportPurityRule(contracts=(an.ImportContract(
            f"{pkg}.compose", ("jax",), recursive=True, exempt=exempt),))
    if kind == "dtype":
        return an.DtypeSafetyRule(scope=(f"{pkg}/backends/*.py",))
    return {"registry": an.RegistryConformanceRule,
            "atomic": an.AtomicWriteRule,
            "schema": an.SchemaDriftRule}[kind]()


#: (reference fixture tree, rule, findings of the bare rule): every one of
#: the reference's ten trees, with the rules its own test runs on it
DIFF_CASES = (
    ("import_bad", "workloads", 2),
    ("import_ok", "workloads", 0),
    ("import_exempt", "compose_exempt", 0),
    ("import_exempt", "compose", 2),
    ("dtype_bad", "dtype", 5),
    ("dtype_ok", "dtype", 0),
    ("registry_bad", "registry", 13),
    ("registry_ok", "registry", 0),
    ("atomic_bad", "atomic", 2),
    ("atomic_ok", "atomic", 0),
    ("schema", "schema", 1),
)


@pytest.mark.parametrize("tree,kind,n", DIFF_CASES,
                         ids=[f"{t}-{k}" for t, k, _ in DIFF_CASES])
def test_port_rules_give_the_reference_findings(tmp_path, tree, kind, n):
    ref_root = os.path.join(REF_FIXTURES, tree)
    port_root = renamed_tree(ref_root, str(tmp_path / tree), "repro",
                             "repro_torch")
    want = rule_of(ref, "repro", kind).run(ref.AnalysisContext(ref_root))
    got = rule_of(port, "repro_torch", kind).run(
        AnalysisContext(port_root))
    assert len(got) == n
    assert list(map(fields, got)) == list(map(to_port, want))
    # and through run_check: suppressions applied, sorted
    want = ref.run_check(root=ref_root, rules=(rule_of(ref, "repro", kind),))
    got = run_check(root=port_root,
                    rules=(rule_of(port, "repro_torch", kind),))
    assert list(map(fields, got)) == list(map(to_port, want))


def test_differential_cases_cover_every_reference_tree():
    trees = {d for d in os.listdir(REF_FIXTURES)
             if os.path.isdir(os.path.join(REF_FIXTURES, d))}
    assert trees == {t for t, _, _ in DIFF_CASES}
    assert len(trees) == 10


def test_schema_pin_and_drift_match_the_reference(tmp_path):
    """The schema round trip on the renamed tree gives the reference's
    findings at each step: pinned, then a key edit without a bump."""
    ref_root = str(tmp_path / "ref")
    shutil.copytree(os.path.join(REF_FIXTURES, "schema"), ref_root)
    port_root = renamed_tree(ref_root, str(tmp_path / "port"), "repro",
                             "repro_torch")
    ref.update_schema_manifest(ref.AnalysisContext(ref_root))
    update_schema_manifest(AnalysisContext(port_root))
    pins = []
    for root, pkg in ((ref_root, "repro"), (port_root, "repro_torch")):
        with open(os.path.join(root, pkg, "analysis",
                               "schema_manifest.json")) as f:
            pins.append({to_port_text(k): v for k, v in
                         json.load(f)["fingerprints"].items()})
        campaign = os.path.join(root, pkg, "launch", "campaign.py")
        with open(campaign) as f:
            src = f.read()
        with open(campaign, "w") as f:
            f.write(src.replace(':{backend}"', ':{backend}:salt"'))
    assert pins[0] == pins[1]
    want = ref.SchemaDriftRule().run(ref.AnalysisContext(ref_root))
    got = SchemaDriftRule().run(AnalysisContext(port_root))
    assert len(got) == 1
    assert list(map(fields, got)) == list(map(to_port, want))


# ---------------------------------------------------------------------------
# import-purity (the reference's tests on the torch twins)
# ---------------------------------------------------------------------------

_WORKLOADS_CONTRACT = ImportContract("repro_torch.workloads",
                                     ("torch", "numpy"), recursive=True)


def test_import_purity_flags_transitive_chain():
    rule = ImportPurityRule(contracts=(_WORKLOADS_CONTRACT,))
    findings = rule.run(fixture_ctx("import_bad"))
    by_ext = {("numpy" if "'numpy'" in f.message else "torch"): f
              for f in findings}
    assert set(by_ext) == {"numpy", "torch"}
    # the numpy leak is transitive: the finding anchors at the import
    # inside the internal helper and spells out the chain
    leak = by_ext["numpy"]
    assert leak.path == "repro_torch/helper.py"
    assert ("repro_torch.workloads -> repro_torch.helper -> numpy"
            in leak.message)
    assert "lazy import" in leak.remediation
    # the torch leak is the try-block import (counted: it runs at import
    # time), anchored in the package itself
    assert by_ext["torch"].path == "repro_torch/workloads/__init__.py"


def test_import_purity_clean_twin_allows_lazy_and_type_checking():
    rule = ImportPurityRule(contracts=(_WORKLOADS_CONTRACT,))
    assert rule.run(fixture_ctx("import_ok")) == []


_EXEMPT_CONTRACT = ImportContract(
    "repro_torch.compose", ("torch",), recursive=True,
    exempt=("repro_torch.compose.torch_engine",
            "repro_torch.compose.executor"))


def test_import_purity_exempt_modules_may_import_torch():
    rule = ImportPurityRule(contracts=(_EXEMPT_CONTRACT,))
    assert rule.run(fixture_ctx("import_exempt")) == []


def test_import_purity_without_exemption_flags_both_backends():
    rule = ImportPurityRule(contracts=(
        ImportContract("repro_torch.compose", ("torch",), recursive=True),))
    findings = rule.run(fixture_ctx("import_exempt"))
    paths = {f.path for f in findings}
    assert "repro_torch/compose/torch_engine.py" in paths
    assert "repro_torch/compose/executor.py" in paths
    # the lazy importers stay clean even without the exemption
    assert "repro_torch/compose/engine.py" not in paths
    assert "repro_torch/compose/__init__.py" not in paths


def test_import_purity_exemption_is_shallow(tmp_path):
    # A *covered* module that eagerly imports an exempt backend still
    # drags torch into the import graph and must be flagged.
    root = tmp_path / "tree"
    shutil.copytree(fx("import_exempt"), root)
    (root / "repro_torch" / "compose" / "eager.py").write_text(
        '"""Covered module importing an exempt backend eagerly."""\n\n'
        "from repro_torch.compose.executor import run_batch\n\n"
        "__all__ = [\"run_batch\"]\n")
    rule = ImportPurityRule(contracts=(_EXEMPT_CONTRACT,))
    findings = rule.run(AnalysisContext(str(root)))
    eager = [f for f in findings
             if "repro_torch.compose.eager" in f.message]
    assert eager, findings
    assert eager[0].path == "repro_torch/compose/executor.py"
    assert ("repro_torch.compose.eager -> repro_torch.compose.executor"
            in eager[0].message)


def test_root_init_is_seen_by_the_port_not_by_the_reference(tmp_path):
    """D31: importing ``repro_torch.__main__`` runs the package root first.
    The port's search starts at the module's ancestors and flags the root's
    torch import; the reference's, on the same tree renamed to ``repro``,
    starts at the module alone and misses it."""
    contracts = (ImportContract("repro_torch.__main__", ("torch", "numpy")),
                 ImportContract("repro_torch.workloads", ("torch", "numpy"),
                                recursive=True))
    findings = ImportPurityRule(contracts=contracts).run(
        fixture_ctx("import_root"))
    assert [f.message.split()[0] for f in findings] == [
        "repro_torch.__main__", "repro_torch.workloads"]
    for f in findings:
        assert (f.path, f.line) == ("repro_torch/device.py", 3)
        assert "-> repro_torch -> repro_torch.device -> torch)" in f.message
    ref_root = renamed_tree(fx("import_root"), str(tmp_path / "ref"),
                            "repro_torch", "repro")
    ref_contracts = tuple(
        ref.ImportContract(c.module.replace("repro_torch", "repro"),
                           c.banned, c.recursive) for c in contracts)
    assert ref.ImportPurityRule(contracts=ref_contracts).run(
        ref.AnalysisContext(ref_root)) == []


def test_module_path_resolves_only_the_port():
    """``src/`` holds both packages: the reference's modules are external
    to the port's analysis."""
    ctx = AnalysisContext(default_root())
    assert ctx.module_path("repro_torch.core") is not None
    assert ctx.module_path("repro.core") is None
    assert ctx.module_path("repro") is None
    assert all(ctx.rel(p).startswith("repro_torch/") for p in ctx.files())


# ---------------------------------------------------------------------------
# dtype-safety
# ---------------------------------------------------------------------------

def test_dtype_rule_flags_every_construction_hazard():
    findings = DtypeSafetyRule(
        scope=("repro_torch/backends/*.py",)).run(fixture_ctx("dtype_bad"))
    msgs = "\n".join(f.message for f in findings)
    assert len(findings) == 5
    assert "np.zeros(dtype=int32) feeds 'addr_buf'" in msgs
    assert "dtype-less np.asarray() feeds 'time_arr'" in msgs
    assert "dtype-less np.asarray() feeds 'addr'" in msgs
    assert "Trace(time_cycles=...)" in msgs
    assert "cycle_stamps.astype(int32)" in msgs
    assert all(f.path == "repro_torch/backends/sim.py" for f in findings)
    assert all(f.remediation for f in findings)


def test_dtype_rule_clean_twin():
    findings = DtypeSafetyRule(
        scope=("repro_torch/backends/*.py",)).run(fixture_ctx("dtype_ok"))
    assert findings == []


@lru_cache(maxsize=None)
def torch_dtype_findings(tree: str) -> tuple:
    return tuple(DtypeSafetyRule().run(fixture_ctx(tree)))


TORCH_CONSTRUCTORS = (("tensor", "addr_t"), ("as_tensor", "time_t"),
                      ("asarray", "addr_a"), ("zeros", "time_z"),
                      ("ones", "addr_o"), ("empty", "time_e"),
                      ("full", "addr_f"), ("arange", "time_r"))


@pytest.mark.parametrize("ctor,name", TORCH_CONSTRUCTORS,
                         ids=[c for c, _ in TORCH_CONSTRUCTORS])
def test_dtype_rule_flags_torch_constructor_without_dtype(ctor, name):
    """D30: torch's dtype is keyword-only and its inference narrows."""
    [f] = [f for f in torch_dtype_findings("dtype_torch_bad")
           if f.message.startswith(f"dtype-less torch.{ctor}() ")]
    assert f"feeds {name!r}" in f.message
    assert f.remediation == ("pass an explicit dtype: "
                             f"torch.{ctor}(..., dtype=torch.int64)")


TORCH_NARROWINGS = ("time_cycles.to(int32)", "addr_lines.to(int32)",
                    "cycle_stamps.int()", "line_ids.type(int32)")


@pytest.mark.parametrize("what", TORCH_NARROWINGS)
def test_dtype_rule_flags_torch_int32_narrowing(what):
    """D30: ``.to(torch.int32)``, ``.to(dtype=torch.int32)``, ``.int()``
    and ``.type(torch.int32)`` narrow like ``.astype(int32)``."""
    [f] = [f for f in torch_dtype_findings("dtype_torch_bad")
           if f.message.startswith(f"{what} narrows ")]
    assert f.remediation == "keep time/addr arrays int64 end-to-end"


def test_dtype_rule_torch_fixture_totals_and_reference_blindness(tmp_path):
    findings = torch_dtype_findings("dtype_torch_bad")
    assert len(findings) == len(TORCH_CONSTRUCTORS) + \
        len(TORCH_NARROWINGS) + 1
    assert "torch.zeros(dtype=int32) feeds 'addr_32'" in "\n".join(
        f.message for f in findings)
    assert torch_dtype_findings("dtype_torch_ok") == ()
    # the reference's rule knows only numpy and jax
    ref_root = renamed_tree(fx("dtype_torch_bad"), str(tmp_path / "ref"),
                            "repro_torch", "repro")
    assert ref.DtypeSafetyRule().run(ref.AnalysisContext(ref_root)) == []


# ---------------------------------------------------------------------------
# registry-conformance
# ---------------------------------------------------------------------------

def test_registry_rule_flags_every_failure_mode():
    findings = RegistryConformanceRule().run(fixture_ctx("registry_bad"))
    msgs = "\n".join(f.message for f in findings)
    assert len(findings) == 13
    assert "duplicate workload registration 'dup'" in msgs
    assert "workload alias 'dup' collides" in msgs
    assert "registers no backends" in msgs
    assert "3 required positional parameter(s)" in msgs
    assert "neither a literal decorator name" in msgs
    assert "duplicate backend registration 'sim'" in msgs
    assert "no run() method" in msgs
    assert "no `mode` attribute" in msgs
    assert "missing/stale for alias 'fast'" in msgs
    assert "'gone'" in msgs
    assert "duplicate device-family registration 'cell'" in msgs
    assert "device-family alias 'cell' collides" in msgs
    assert ("device-family builder 'build_other' takes 2 required "
            "positional parameter(s)") in msgs
    assert all(f.path.startswith("repro_torch/") for f in findings)


def test_registry_rule_clean_twin_accepts_factory_idiom():
    assert RegistryConformanceRule().run(fixture_ctx("registry_ok")) == []


# ---------------------------------------------------------------------------
# atomic-write + suppressions + baselines
# ---------------------------------------------------------------------------

def test_atomic_rule_flags_raw_writes():
    findings = AtomicWriteRule().run(fixture_ctx("atomic_bad"))
    # the bare rule sees both raw opens; suppressions are a layer above
    assert len(findings) == 2
    assert all(f.rule == "atomic-write" for f in findings)
    assert all("open(..., 'w')" in f.message for f in findings)


def test_atomic_rule_clean_twin_accepts_sanctioned_idioms():
    assert AtomicWriteRule().run(fixture_ctx("atomic_ok")) == []


def test_inline_suppression_drops_only_the_waived_finding():
    findings = run_check(root=fx("atomic_bad"),
                         rules=(AtomicWriteRule(),))
    assert len(findings) == 1
    ctx = fixture_ctx("atomic_bad")
    lines = ctx.source_lines(ctx.abs(findings[0].path))
    assert "allow(atomic-write)" not in lines[findings[0].line - 1]


def test_baseline_roundtrip(tmp_path):
    findings = run_check(root=fx("atomic_bad"),
                         rules=(AtomicWriteRule(),))
    assert findings
    baseline = tmp_path / "baseline.json"
    write_baseline(findings, str(baseline))
    survivors = run_check(root=fx("atomic_bad"),
                          rules=(AtomicWriteRule(),),
                          baseline=load_baseline(str(baseline)))
    assert survivors == []


# ---------------------------------------------------------------------------
# schema-drift: pin -> edit -> detect
# ---------------------------------------------------------------------------

def test_schema_drift_roundtrip(tmp_path):
    root = str(tmp_path / "tree")
    shutil.copytree(fx("schema"), root)
    rule = SchemaDriftRule()

    # unpinned tree: the missing manifest is itself a finding
    [f] = rule.run(AnalysisContext(root))
    assert "manifest missing" in f.message
    assert f.path == "repro_torch/analysis/schema_manifest.json"

    update_schema_manifest(AnalysisContext(root))
    assert rule.run(AnalysisContext(root)) == []

    # comments / docstrings / moving code never trip the fingerprint
    campaign = os.path.join(root, "repro_torch", "launch", "campaign.py")
    src = open(campaign).read()
    open(campaign, "w").write(src.replace(
        "SCHEMA_VERSION = 1",
        "# a comment, some blank lines\n\n\nSCHEMA_VERSION = 1"))
    assert rule.run(AnalysisContext(root)) == []

    # a semantic edit to the key without a version bump: the bug
    src = open(campaign).read()
    open(campaign, "w").write(src.replace(
        ':{backend}"', ':{backend}:salt"'))
    [f] = rule.run(AnalysisContext(root))
    assert f.path == "repro_torch/launch/campaign.py"
    assert "changed but SCHEMA_VERSION is still 1" in f.message
    assert "python -m repro_torch check --update-schema-manifest" in \
        f.remediation

    # bumping the version flips the finding to "manifest is stale"
    src = open(campaign).read()
    open(campaign, "w").write(src.replace(
        "SCHEMA_VERSION = 1", "SCHEMA_VERSION = 2"))
    [f] = rule.run(AnalysisContext(root))
    assert "manifest still pins" in f.message

    # re-pinning closes the loop
    update_schema_manifest(AnalysisContext(root))
    assert rule.run(AnalysisContext(root)) == []


def _copy_real_key_files(dst, src_root, pkg):
    for rel in (f"{pkg}/launch/campaign.py", f"{pkg}/workloads/spec.py",
                f"{pkg}/analysis/schema_manifest.json"):
        out = dst / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(src_root, rel), out)


def test_real_cache_key_edit_without_bump_is_caught(tmp_path):
    """Against the port's *real* pinned functions: an edit to
    CampaignRunner._key with no SCHEMA_VERSION bump is a finding."""
    _copy_real_key_files(tmp_path, default_root(), "repro_torch")
    assert SchemaDriftRule().run(AnalysisContext(str(tmp_path))) == []

    campaign = tmp_path / "repro_torch" / "launch" / "campaign.py"
    src = campaign.read_text()
    needle = '"package": PACKAGE,'
    assert src.count(needle) == 1, "cache-key payload changed; update test"
    campaign.write_text(src.replace(needle, needle + ' "salt": 1,'))
    findings = SchemaDriftRule().run(AnalysisContext(str(tmp_path)))
    assert len(findings) == 1
    assert "CampaignRunner._key" in findings[0].message
    assert "SCHEMA_VERSION" in findings[0].message


def test_real_content_hash_edit_without_bump_is_caught(tmp_path):
    _copy_real_key_files(tmp_path, default_root(), "repro_torch")
    spec = tmp_path / "repro_torch" / "workloads" / "spec.py"
    src = spec.read_text()
    needle = "def content_hash(self) -> str:"
    assert src.count(needle) == 1, "content_hash changed; update test"
    spec.write_text(src.replace(needle, needle + "\n        _ = 0"))
    [f] = SchemaDriftRule().run(AnalysisContext(str(tmp_path)))
    assert "WorkloadSpec.content_hash" in f.message
    assert f.path == "repro_torch/workloads/spec.py"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_exit_codes():
    assert check_main(["--root", fx("import_ok")]) == 0
    assert check_main(["--root", fx("atomic_bad")]) == 1
    assert check_main(["--root", fx("atomic_bad"),
                       "--rules", "no-such-rule"]) == 2
    assert check_main(["--root", os.path.join(FIXTURES, "missing")]) == 2
    # a reference tree has no repro_torch/ package: a bad invocation
    assert check_main(["--root", os.path.join(REF_FIXTURES,
                                              "import_ok")]) == 2


def test_cli_json_format(capsys):
    rc = check_main(["--root", fx("atomic_bad"), "--format", "json"])
    assert rc == 1
    data = json.loads(capsys.readouterr().out)
    assert data["count"] == 1
    [finding] = data["findings"]
    assert finding["rule"] == "atomic-write"
    assert finding["path"] == "repro_torch/cluster/state.py"
    assert finding["remediation"]


def test_cli_list_rules(capsys):
    assert check_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in default_rules():
        assert rule.id in out


def test_cli_write_baseline_then_clean(tmp_path):
    baseline = str(tmp_path / "baseline.json")
    assert check_main(["--root", fx("atomic_bad"),
                       "--write-baseline", "--baseline", baseline]) == 0
    assert check_main(["--root", fx("atomic_bad"),
                       "--baseline", baseline]) == 0


def test_cli_writes_only_the_ports_files(tmp_path):
    """Both packages share the root ``src/``: the port's default baseline
    and its manifest update never touch a file of the reference."""
    assert DEFAULT_BASELINE == ".repro-torch-check-baseline.json"
    assert DEFAULT_BASELINE != REF_BASELINE
    _copy_real_key_files(tmp_path, default_root(), "repro_torch")
    _copy_real_key_files(tmp_path, default_root(), "repro")

    def snapshot():
        out = {}
        for dirpath, _, filenames in os.walk(tmp_path):
            for fn in filenames:
                path = os.path.join(dirpath, fn)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, tmp_path)] = f.read()
        return out

    before = snapshot()
    assert check_main(["--root", str(tmp_path),
                       "--update-schema-manifest"]) == 0
    assert check_main(["--root", str(tmp_path), "--write-baseline"]) == 0
    after = snapshot()
    changed = {k for k in after if before.get(k) != after[k]}
    assert changed == {DEFAULT_BASELINE}   # the manifest is already pinned
    assert all(after[k] == v for k, v in before.items())
    assert not (tmp_path / REF_BASELINE).exists()


# ---------------------------------------------------------------------------
# the lock: the port's own tree stays clean
# ---------------------------------------------------------------------------

def test_repo_tree_is_clean():
    """`python -m repro_torch check` on the real source tree reports
    nothing: the contracts hold at head."""
    assert run_check() == []


def test_repo_tree_has_no_finding_with_waivers_ignored():
    """With suppressions ignored the tree is still clean: the last waiver,
    the ``"tpu" -> "tpu_graph"`` alias, went with the graph-walking
    backend, which now declares it."""
    ctx = AnalysisContext(default_root())
    findings = [f for rule in default_rules() for f in rule.run(ctx)]
    assert findings == []
    spec = ctx.source_lines(ctx.abs("repro_torch/workloads/spec.py"))
    assert not any("repro: allow" in line for line in spec)


def test_repo_schema_manifest_is_committed():
    manifest = os.path.join(default_root(), "repro_torch", "analysis",
                            "schema_manifest.json")
    assert os.path.isfile(manifest)
    data = json.load(open(manifest))
    assert set(data) == {"schema_version", "fingerprints"}
    assert len(data["fingerprints"]) == 2
    assert data["schema_version"] == 3


def test_content_hash_pin_is_the_references_and_key_pin_the_ports():
    root = default_root()
    with open(os.path.join(root, "repro_torch", "analysis",
                           "schema_manifest.json")) as f:
        mine = json.load(f)
    with open(os.path.join(root, "repro", "analysis",
                           "schema_manifest.json")) as f:
        theirs = json.load(f)
    assert mine["schema_version"] == theirs["schema_version"] == 3
    pin = "workloads/spec.py::WorkloadSpec.content_hash"
    assert mine["fingerprints"][f"repro_torch/{pin}"] == \
        theirs["fingerprints"][f"repro/{pin}"] == \
        "19a01d9a59cdad57ac94b6a784271ed4dc360a26dc52707d394987c5453c3bea"
    key = "launch/campaign.py::CampaignRunner._key"
    fps, _ = port.schema.current_fingerprints(AnalysisContext(root))
    assert mine["fingerprints"][f"repro_torch/{key}"] == \
        fps[f"repro_torch/{key}"]
    # the port's key adds the "package" component
    assert mine["fingerprints"][f"repro_torch/{key}"] != \
        theirs["fingerprints"][f"repro/{key}"]
