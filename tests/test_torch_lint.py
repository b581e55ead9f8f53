"""tonylint on the port (tony_tpu_torch/devtools/{tonylint,protocol}.py).

1. **The reference's golden fixtures, through the port's linter.** Each
   bad/clean fixture of ``tests/test_lint.py`` runs with its synthetic
   repo's package, imports and paths renamed to ``tony_tpu_torch`` and
   the port's ``Linter`` in place of the reference's: every rule flags
   and clears the same lines as the reference's linter does.
2. **The port's tree.** ``tony_tpu_torch/`` reports no finding: any
   finding fails.
"""

from __future__ import annotations

import inspect
import os
import re

import pytest

import test_lint as ref
from tony_tpu_torch.devtools import tonylint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PKG = re.compile(r"\btony_tpu\b")

#: The reference's fixture tests (``tests/test_lint.py``): every test there
#: that builds a synthetic repo in ``tmp_path``.
FIXTURES = (
    "test_conf_key_bad_and_clean",
    "test_fault_site_bad_and_clean",
    "test_fault_site_missing_call_site_detected",
    "test_event_type_bad_and_clean",
    "test_rpc_parity_bad_and_clean",
    "test_durable_write_bad_and_clean",
    "test_clock_bad_and_clean",
    "test_span_leak_bad_and_clean",
    "test_thread_leak_bad_and_clean",
    "test_lock_blocking_bad_and_clean",
    "test_bare_except_bad_and_clean",
    "test_suppression_comment",
    "test_directive_parity_bad_and_clean",
    "test_directive_parity_missing_dedup_guard",
    "test_journal_parity_bad_and_clean",
    "test_fence_coverage_bad_and_clean",
    "test_fence_coverage_sees_through_delegation",
    "test_beacon_parity_bad_and_clean",
    "test_terminal_state_bad_and_clean",
    "test_metrics_registry_bad_and_clean",
    "test_metrics_registry_dead_entry_detected",
)

#: (rule, file, the name the finding quotes) -> why the port keeps it.
#: Empty: every module of the reference has its counterpart, so the
#: observer verbs call the coordinator's profile.start, profile.status and
#: alerts handlers, which were the last findings.
KNOWN_FINDINGS: dict = {}


def _port(text: str) -> str:
    return _PKG.sub("tony_tpu_torch", text)


@pytest.fixture
def port_linter(monkeypatch):
    """The reference's fixture harness, renamed to the port's package and
    running the port's Linter."""
    lint_snippet, lint_files = ref._lint_snippet, ref._lint_files

    def snippet(tmp_path, code, rules, rel="tony_tpu/snippet.py"):
        return lint_snippet(tmp_path, _port(code), rules, rel=_port(rel))

    def files(tmp_path, fs, rules):
        return lint_files(tmp_path, {_port(k): _port(v)
                                     for k, v in fs.items()}, rules)

    monkeypatch.setattr(ref, "Linter", tonylint.Linter)
    monkeypatch.setattr(ref, "_lint_snippet", snippet)
    monkeypatch.setattr(ref, "_lint_files", files)


def test_fixture_list_is_every_reference_fixture():
    found = sorted(name for name, fn in vars(ref).items()
                   if name.startswith("test_") and callable(fn)
                   and list(inspect.signature(fn).parameters) == ["tmp_path"])
    assert found == sorted(FIXTURES)


@pytest.mark.parametrize("name", FIXTURES)
def test_reference_fixture_through_the_port(name, tmp_path, port_linter):
    getattr(ref, name)(tmp_path)


def test_port_tree_reports_exactly_the_known_findings():
    findings, suppressed = tonylint.run_lint(REPO_ROOT)
    got = {}
    for f in findings:
        quoted = re.search(r"'([^']+)'", f.message)
        key = (f.rule, f.file.replace(os.sep, "/"),
               quoted.group(1) if quoted else "")
        assert key not in got, f"finding twice: {f}"
        got[key] = f
    unknown = sorted(str(got[k]) for k in set(got) - set(KNOWN_FINDINGS))
    assert not unknown, "new lint findings:\n" + "\n".join(unknown)
    gone = sorted(set(KNOWN_FINDINGS) - set(got))
    assert not gone, f"known findings that no longer fire (prune them " \
                     f"here and in ROADMAP.md): {gone}"
    assert len(findings) == len(KNOWN_FINDINGS) == 0
    assert suppressed == []


def test_port_linter_lints_the_port_not_the_reference():
    linter = tonylint.Linter(REPO_ROOT)
    assert linter.pkg == os.path.join(REPO_ROOT, "tony_tpu_torch")
    findings, _ = tonylint.run_lint(REPO_ROOT, rules=["durable-write"])
    assert findings == []
