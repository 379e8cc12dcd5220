"""The port's locking held to the reference's lints.

Since the port runs threads of its own (``delta-warmup``,
``ingest-prewarm``, the audit warm, the reactor's pump, the sweep's
``external-prefetch``), the reference's ``analysis/selflint.py`` in its
``--locks``, ``--lockorder``, ``--rebind``, ``--allocs`` and
``--retrace`` modes must report clean over the port's ``engine``,
``enforce``, ``watch``, ``controllers``, ``audit``, ``webhook``,
``client`` and ``externaldata``.  The test imports the lint; the port
package does not.
"""

import os

import pytest

from gatekeeper_tpu.analysis import selflint

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gatekeeper_tpu_torch")
DIRS = ("engine", "enforce", "watch", "controllers", "audit", "webhook",
        "client", "externaldata")
MODES = {
    "--locks": selflint.lint_lock_paths,
    "--lockorder": selflint.lint_lockorder_paths,
    "--rebind": selflint.lint_rebind_paths,
    "--allocs": selflint.lint_allocs_paths,
    "--retrace": selflint.lint_retrace_paths,
}


def _paths():
    return [os.path.join(PKG, d) for d in DIRS]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_port_lints_clean(mode):
    assert all(os.path.isdir(p) for p in _paths())
    findings = MODES[mode](_paths())
    assert findings == [], "\n".join(findings)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_lint_entry_point_agrees(mode, capsys):
    """``python -m gatekeeper_tpu.analysis.selflint <mode> <dirs>`` exits
    0 (its exit status counts the findings)."""
    assert selflint.main([mode] + _paths()) == 0
    capsys.readouterr()


def test_the_lock_lint_sees_the_port(tmp_path):
    """The lock lint reads the port's files: a copy of the external-data
    runtime with a provider round moved under its registry lock is
    flagged."""
    src = open(os.path.join(PKG, "externaldata", "runtime.py")).read()
    bad = src.replace(
        "        with self._lock:\n            return self._entries.get(name)",
        "        with self._lock:\n"
        "            self.client.fetch(None, None, [])\n"
        "            return self._entries.get(name)")
    assert bad != src
    (tmp_path / "runtime.py").write_text(bad)
    findings = selflint.lint_lock_paths([str(tmp_path)])
    assert findings and "fetch" in findings[0]
