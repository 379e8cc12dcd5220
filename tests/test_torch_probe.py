"""The port's self-test probe (``gatekeeper_tpu_torch.client.probe``),
the engine half of the reference's client/probe.py: every scenario
passes on the port's ``local`` and ``torch`` drivers (TorchDriver on the
CPU, with the small-workload threshold at its default and at 0), a
failing scenario carries the engine dump, ``main`` probes both on the
device asked for and names it in its verdict, ``--builtins`` lists the
reference's registry, the exit codes of ``--lint`` (clean, error,
warnings, ``--strict`` with the scalar-fallback pins, unreadable input)
equal the reference's on the same files, ``--cost`` runs a measured
forced full sweep, and each subcommand that needs a layer the port has
not got raises ClientError naming its ROADMAP item."""

import pytest
import yaml

from gatekeeper_tpu.client import probe as ref_probe

from gatekeeper_tpu_torch.client import probe
from gatekeeper_tpu_torch.client.local_driver import LocalDriver
from gatekeeper_tpu_torch.client.probe import Probe, ProbeError, SCENARIOS
from gatekeeper_tpu_torch.engine import torch_driver
from gatekeeper_tpu_torch.engine.torch_driver import TorchDriver
from gatekeeper_tpu_torch.errors import ClientError


@pytest.fixture(autouse=True)
def _fresh_runtimes(monkeypatch):
    """No external-data runtime in either package, as in a freshly
    started probe process: ``--lint`` checks provider references against
    an installed runtime's providers, so one left by another test would
    change both sides' findings."""
    from gatekeeper_tpu.externaldata import runtime as j_runtime
    from gatekeeper_tpu_torch.externaldata import runtime as t_runtime
    monkeypatch.setattr(j_runtime, "_runtime", None)
    monkeypatch.setattr(t_runtime, "_runtime", None)


@pytest.mark.parametrize("small", [None, 0])
@pytest.mark.parametrize("driver", ["local", "torch"])
def test_all_probe_scenarios_pass(driver, small, monkeypatch):
    if small is not None:
        monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", small)
    drv = LocalDriver() if driver == "local" else TorchDriver(device="cpu")
    funcs = Probe(drv).test_funcs()
    assert set(funcs) == set(SCENARIOS) == set(ref_probe.SCENARIOS)
    assert len(funcs) == 12
    for _name, fn in funcs.items():
        fn()


def test_probe_rejects_in_use_driver():
    from gatekeeper_tpu_torch.client.client import Backend
    from gatekeeper_tpu_torch.target.k8s import K8sValidationTarget
    d = LocalDriver()
    Backend(d).new_client([K8sValidationTarget()])
    with pytest.raises(ValueError, match="fresh driver"):
        Probe(d)


def test_probe_failure_carries_engine_dump(monkeypatch):
    p = Probe(TorchDriver(device="cpu"))

    def broken(_client):
        raise AssertionError("engine disagrees")

    monkeypatch.setitem(SCENARIOS, "Deny All", broken)
    with pytest.raises(ProbeError) as ei:
        p.test_funcs()["Deny All"]()
    assert "engine disagrees" in str(ei.value)
    assert "Engine dump:" in str(ei.value)


def test_main_probes_both_drivers_on_the_device_asked_for(capsys):
    assert probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "PROBE PASS (torch engine served by: cpu)"
    for label in ("local", "torch"):
        assert sum(1 for line in out
                   if line.startswith(f"  ok   [{label}]")) == 12


def test_main_verdict_unavailable_without_a_card(monkeypatch, capsys):
    """Without ``--device`` the TorchDriver is built on the card; where
    it cannot be, no [torch] scenario runs and the verdict says
    ``unavailable``."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main([]) == 1
    out = capsys.readouterr()
    assert out.out.strip().splitlines()[-1] == \
        "PROBE FAIL (torch engine served by: unavailable)"
    assert "FAIL [torch] <driver construction>" in out.err


def test_builtins_listing_equals_the_reference(capsys):
    assert probe.main(["--builtins"]) == 0
    out = capsys.readouterr().out
    assert "external_data" in out and "UNSUPPORTED" in out
    assert probe.list_builtins() == ref_probe.list_builtins()


GOOD_REGO = """package probeok
violation[{"msg": msg}] {
  input.review.object.spec.replicas > 3
  msg := "too many"
}
"""

BAD_REGO = """package probebad
violation[{"msg": msg}] {
  x := no.such_builtin(1)
  msg := "bad"
}
"""

# lowers to no device program (a dynamic path under a leaf binding):
# the rego_not_vectorizable warning, pinned for K8sAgileLabels' kind
SCALAR_REGO = """package k8sagilelabels
violation[{"msg": msg}] {
  some k
  v := input.review.object.metadata.labels[k]
  x := input.review.object.spec[v]
  msg := sprintf("%v", [x])
}
"""

EXT_REGO = """package probeext
violation[{"msg": msg}] {
  r := external_data({"provider": "nowhere", "keys": ["a"]})
  count(r.errors) > 0
  msg := "unsigned"
}
"""


def _write_template(tmp_path, name, kind, rego):
    doc = {"apiVersion": "templates.gatekeeper.sh/v1alpha1",
           "kind": "ConstraintTemplate",
           "metadata": {"name": kind.lower()},
           "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                    "targets": [{"target": "admission.k8s.gatekeeper.sh",
                                 "rego": rego}]}}
    p = tmp_path / name
    p.write_text(yaml.safe_dump(doc))
    return str(p)


def test_severity_rc_table():
    for n_err, n_warn in ((0, 0), (0, 3), (1, 0), (2, 5)):
        assert probe._severity_rc(n_err, n_warn) == \
            ref_probe._severity_rc(n_err, n_warn)


@pytest.mark.parametrize("case, flags", [
    ("good", []), ("bad", []), ("scalar", []), ("scalar", ["--strict"]),
    ("pinned", ["--strict"]), ("ext", []), ("missing", []),
    ("library", ["--library"]), ("library", ["--library", "--strict"]),
])
def test_lint_exit_codes_equal_the_reference(case, flags, tmp_path,
                                             capsys):
    """``--lint`` on the same files exits as the reference's does, and
    prints the same diagnostics."""
    files = {
        "good": lambda: [_write_template(tmp_path, "ok.yaml", "ProbeOk",
                                         GOOD_REGO)],
        "bad": lambda: [_write_template(tmp_path, "bad.yaml", "ProbeBad",
                                        BAD_REGO)],
        "scalar": lambda: [_write_template(tmp_path, "s.yaml", "ProbeDyn",
                                           SCALAR_REGO)],
        "pinned": lambda: [_write_template(tmp_path, "p.yaml",
                                           "K8sAgileLabels", SCALAR_REGO)],
        "ext": lambda: [_write_template(tmp_path, "e.yaml", "ProbeExt",
                                        EXT_REGO)],
        "missing": lambda: [str(tmp_path / "missing.yaml")],
        "library": lambda: [],
    }[case]()
    argv = ["--lint"] + files + flags
    rc = probe.main(argv)
    out = capsys.readouterr().out
    want = ref_probe.main(argv)
    ref_out = capsys.readouterr().out
    assert rc == want
    assert out == ref_out
    assert rc == {"good": 0, "bad": 2, "scalar": 1 if flags else 0,
                  "pinned": 0, "ext": 0, "missing": 2,
                  "library": 0}[case]


def test_scalar_fallback_pins_read_the_port_table():
    assert probe._scalar_fallback_pins() == ref_probe._scalar_fallback_pins()
    assert "K8sAgileLabels" in probe._scalar_fallback_pins()


def test_cost_runs_a_measured_sweep(monkeypatch, capsys):
    monkeypatch.setenv("GATEKEEPER_COST_PROBE_N", "40")
    assert probe.main(["--cost", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "measured device_s=" in out and "48 templates" in out
    monkeypatch.setenv("GATEKEEPER_COST_BUDGET_UNITS", "0.001")
    assert probe.main(["--cost", "--device", "cpu"]) == 1
    assert "over-budget" in capsys.readouterr().out


@pytest.mark.parametrize("flag, item", [
    ("--footprint", "A8"), ("--certify", "A8"),
    ("--health", "A8"), ("--trace", "A8"), ("--pages", "A8"),
    ("--compilesurface", "A8"), ("--memsurface", "A8"),
    ("--shardplan", "A10"),
])
def test_unported_subcommands_raise_naming_their_item(flag, item):
    with pytest.raises(ClientError, match=f"not yet ported.*ROADMAP {item}"):
        probe.main([flag, "--device", "cpu"])


def test_policyset_report_equals_the_reference(capsys):
    """``--policyset``: the whole-set report over the library, its lines
    and rc equal to the reference's."""
    rc = probe.main(["--policyset"])
    out = capsys.readouterr().out
    assert rc == ref_probe.main(["--policyset"])
    assert out == capsys.readouterr().out
    assert "shared " in out and "1 shared subprogram group(s)" in out


@pytest.mark.parametrize("flag", ["--whatif", "--rollout"])
def test_whatif_and_rollout_run_on_the_device_asked_for(flag, monkeypatch,
                                                       capsys):
    """``--whatif`` and ``--rollout`` on ``--device cpu``: every parity
    and gate check passes with the reference's rc (0), and the summary
    names the device the TorchDrivers ran on."""
    monkeypatch.setenv("GATEKEEPER_WHATIF_PROBE_N", "120")
    monkeypatch.setenv("GATEKEEPER_ROLLOUT_PROBE_N", "80")
    monkeypatch.setattr(torch_driver, "SMALL_WORKLOAD_EVALS", 0)
    rc = probe.main([flag, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FAIL" not in out
    assert "(torch engine on cpu)" in out
    assert rc == ref_probe.main([flag])
