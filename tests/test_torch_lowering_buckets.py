"""The port's lowering-bucket table is a contract, as the reference's
is: no shipped template may silently change evaluation bucket
(device-lowered / scalar-fallback / rejected).  The port computes the
table from its own lowering (``gatekeeper_tpu_torch.library.buckets``);
it equals the port's committed ``lowering_buckets.json`` and the
reference's committed table entry for entry, and no template is
rejected."""

import pytest

from gatekeeper_tpu.library.buckets import load_committed as ref_committed

from gatekeeper_tpu_torch.library import buckets
from gatekeeper_tpu_torch.library.buckets import (compute_buckets,
                                                  load_committed)


@pytest.fixture(scope="module")
def computed():
    return compute_buckets()


def _diffs(got: dict, want: dict) -> list[str]:
    out = []
    for name in sorted(set(got) | set(want)):
        g = got.get(name, "<template removed>")
        w = want.get(name, "<not in committed table>")
        if g != w:
            out.append(f"  {name}: committed={w!r} computed={g!r}")
    return out


def test_no_template_silently_changes_bucket(computed):
    diffs = _diffs(computed, load_committed())
    assert not diffs, (
        "template lowering buckets changed — if deliberate, regenerate "
        "the table with `python -m gatekeeper_tpu_torch.library.buckets`:\n"
        + "\n".join(diffs))


def test_the_port_table_equals_the_reference_table(computed):
    assert not _diffs(load_committed(), ref_committed())
    assert not _diffs(computed, ref_committed())


def test_no_rejected_templates_in_corpus(computed):
    assert not [k for k, v in computed.items() if v.startswith("rejected")]


def test_the_table_covers_the_library_and_the_demos(computed):
    from gatekeeper_tpu_torch.library.templates import LIBRARY
    assert set(LIBRARY) <= set(computed)
    demos = [k for k in computed if " (demo/" in k]
    assert demos and all(k.split(" (")[0] for k in demos)
    counts = {}
    for v in computed.values():
        counts[v.split(":")[0]] = counts.get(v.split(":")[0], 0) + 1
    assert set(counts) <= {"device-lowered", "scalar-fallback"}
    assert buckets.render_markdown(computed).endswith(
        f"of {len(computed)} total)\n")
