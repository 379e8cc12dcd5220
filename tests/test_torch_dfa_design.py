"""K3 and K3b (the regex byte-DFA scan, ``csrc/dfa.cu``) as designed for
the H100: rows that are not ok are not scanned, only each row's live
bytes are stepped, the zero tail and the TERM step collapse to z(s) =
trans[s, 0] applied until a fixed point, and the table is staged in
shared memory at the narrowest width that holds a state (or read from
global memory past the card's shared-memory limit), beside the tile's
rows.

On the CPU a numpy model of the kernel's order of steps is held, bit for
bit, against the JAX package's ``_dfa_device_table`` and
``match_packed_device`` and against ``dfa_table_plain`` on the library's
real DFAs and on synthetic ones (z with a fixed point, z made of 2- and
3-cycles, 1 to 1,024 states); :func:`dfa.plan` is checked at the path's
shapes and at the branch edge.  The ``cuda``-marked tests run the same
cases through K3 and K3b against their plain versions on the card.  This
file imports jax only inside the CPU tests that need it, so on a machine
with a card and no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_dfa_design.py
"""

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch.kernels import dfa
from gatekeeper_tpu_torch.ops import regex_dfa

from chip_smoke import (K3_PATTERNS, k3_dtypes, k3_rows, k3_shifted,
                        k3_synthetic_dfa)

PREFIX = b"\x00s:"
H100 = dfa.Limits(block_smem=232448, sm_smem=233472, sms=132,
                  sm_threads=2048)


# -- the inputs (the generators are chip_smoke.py's, which runs the same
# cases on the card)


def _library_dfa(pattern: str):
    d = regex_dfa.compile_dfa(pattern)
    assert d is not None and d.start == 0, pattern
    return d.trans.astype(np.int32), d.accept.copy()


ALNUM = b"abcdef0123456789:@sha256.xyzPASSWORDsecret/-_"


def _cases():
    """(name, trans, accept, strbytes, ok, xv, prefix): seeded cases over
    the library's DFAs and synthetic ones, row widths a multiple of 16
    and not, past the kernel's 128 register-held bytes, prefix 0 and 3."""
    rng = np.random.default_rng(12)
    out = []
    for i, pat in enumerate(K3_PATTERNS):
        tr, ac = _library_dfa(pat)
        for width, prefix in ((128, 3), (40, 3), (144, 0)):
            sb, ok, xv = k3_rows(rng, 96, width, prefix, ALNUM)
            if pat.startswith("@sha"):          # some digests that match
                for u in range(0, 40, 8):
                    if ok[u] and width - prefix >= 71:
                        img = b"@sha256:" + bytes(rng.choice(
                            np.frombuffer(b"0123456789abcdef", np.uint8),
                            64))
                        sb[u, prefix:] = 0
                        sb[u, prefix:prefix + len(img)] = \
                            np.frombuffer(img, np.uint8)
            out.append((f"lib{i}-w{width}-p{prefix}", tr, ac, sb, ok, xv,
                        prefix))
    for states in (1, 2, 3, 7, 256, 257, 440, 450, 904, 905, 1024):
        for z_kind in ("fixed", "cycles"):
            tr, ac = k3_synthetic_dfa(rng, states, z_kind == "cycles")
            for width, prefix in ((128, 3), (100, 0)):
                sb, ok, xv = k3_rows(rng, 64, width, prefix,
                                   bytes(range(1, 256)))
                out.append((f"S{states}-{z_kind}-w{width}-p{prefix}", tr,
                            ac, sb, ok, xv, prefix))
    return out


CASES = _cases()
CASE_IDS = [c[0] for c in CASES]


# -- the model of the kernel's order of steps


def model_table(trans, accept, strbytes, ok, xv, prefix: int):
    """The kernel's computation, in numpy: the table narrowed to the
    stored width as the block stages it; rows that are not ok take
    ``xv``; j* the last column at or after ``prefix`` holding a nonzero
    byte; columns prefix..j* stepped; then z applied W - j* times with
    the fixed-point stop; the accept flag."""
    states = trans.shape[0]
    stored = np.uint8 if states <= 256 else np.uint16
    t = trans.astype(stored).reshape(-1)              # [S][256]
    n_ids, width = strbytes.shape
    out = xv.copy()
    z_steps = 0
    for u in np.nonzero(ok)[0]:
        nz = np.nonzero(strbytes[u, prefix:])[0]
        jstar = prefix + int(nz[-1]) if len(nz) else prefix - 1
        s = 0
        for j in range(prefix, jstar + 1):
            s = int(t[s * 256 + int(strbytes[u, j])])
        for _ in range(width - jstar):
            nxt = int(t[s * 256])
            if nxt == s:
                break
            s = nxt
            z_steps += 1
        out[u] = accept[s]
    model_table.z_steps = z_steps
    return out


def _plain(trans, accept, sb, ok, xv, prefix, dtype=torch.int32):
    return dfa.dfa_table_plain(
        torch.from_numpy(trans).to(dtype), torch.from_numpy(accept),
        torch.from_numpy(sb), torch.from_numpy(ok), torch.from_numpy(xv),
        prefix).numpy()


# -- on the CPU


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_model_equals_plain(case):
    _name, trans, accept, sb, ok, xv, prefix = case
    assert np.array_equal(model_table(trans, accept, sb, ok, xv, prefix),
                          _plain(trans, accept, sb, ok, xv, prefix))


@pytest.mark.parametrize("case", [c for c in CASES if c[6] == 3],
                         ids=[c[0] for c in CASES if c[6] == 3])
def test_model_equals_jax_device_table(case):
    """The reference's in-program scan: prefix 3, TERM, ``where``."""
    import jax.numpy as jnp

    from gatekeeper_tpu.engine.veval import _dfa_device_table
    _name, trans, accept, sb, ok, xv, prefix = case
    arrays = {"d.trans": jnp.asarray(trans), "d.accept": jnp.asarray(accept),
              "__strbytes__": jnp.asarray(sb),
              "__strdfaok__": jnp.asarray(ok), "d.xv": jnp.asarray(xv)}
    want = np.asarray(_dfa_device_table(arrays, "d"))
    assert np.array_equal(model_table(trans, accept, sb, ok, xv, prefix),
                          want)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_model_equals_jax_match_packed_device(case):
    """The standalone twin over the payload with its terminator column:
    on ok rows the kernel's verdict is ``match_packed_device`` of the
    bytes after the prefix with one zero column appended."""
    from gatekeeper_tpu.ops.regex_dfa import DFA, match_packed_device
    _name, trans, accept, sb, ok, xv, prefix = case
    packed = np.concatenate([sb[:, prefix:],
                             np.zeros((sb.shape[0], 1), np.uint8)], axis=1)
    want = match_packed_device(DFA(trans, accept, 0, ""), packed)
    got = model_table(trans, accept, sb, np.ones_like(ok), xv, prefix)
    assert np.array_equal(got, want)


def test_cycles_need_every_tail_step():
    """A z made of 2- and 3-cycles has no fixed point: the tail runs all
    W - j* steps, and the verdict depends on that count's parity, so a
    tail cut short would be wrong."""
    rng = np.random.default_rng(3)
    trans, _ = k3_synthetic_dfa(rng, 7, True)
    z = trans[:, 0]
    assert all(z[s] != s for s in range(7))
    accept = np.zeros(7, dtype=bool)
    accept[1] = True                     # state 0 -> z: 1 -> 0 -> 1 ...
    sb = np.zeros((4, 16), dtype=np.uint8)
    ok = np.ones(4, dtype=bool)
    xv = np.zeros(4, dtype=bool)
    for prefix in (0, 1, 2, 3):
        got = model_table(trans, accept, sb, ok, xv, prefix)
        assert got.tolist() == [(16 - prefix + 1) % 2 == 1] * 4
        assert model_table.z_steps == 4 * (16 - prefix + 1)
        assert np.array_equal(got, _plain(trans, accept, sb, ok, xv,
                                          prefix))


def test_fixed_point_cuts_the_tail():
    """The library's digest DFA reaches a fixed point of z within two
    steps of any state: an empty row costs at most two z lookups."""
    trans, accept = _library_dfa("@sha256:[a-f0-9]{64}$")
    z = trans[:, 0]
    assert all(z[z[z[s]]] == z[z[s]] for s in range(len(z)))
    sb = np.zeros((8, 128), dtype=np.uint8)
    sb[:, :3] = np.frombuffer(PREFIX, np.uint8)
    ok = np.ones(8, dtype=bool)
    model_table(trans, accept, sb, ok, ok, 3)
    assert model_table.z_steps <= 2 * 8


@pytest.mark.parametrize("n_b,n_ids,width,states,want", [
    # the store's table: 75 states, 4,096 ids; tiles of 32 ids reach
    # every SM (128 blocks)
    (1, 4096, 128, 75, dfa.Plan(1, 512, 32, 128, 9, 14288)),
    # the library's and the fleet's: 4 tiles a table
    (1, 128, 128, 75, dfa.Plan(1, 512, 32, 4, 9, 14288)),
    (4, 128, 128, 75, dfa.Plan(1, 512, 32, 4, 9, 14288)),
    # a large table of ids: tiles of 512, two blocks an SM, looping
    (1, 262144, 128, 75, dfa.Plan(1, 512, 512, 264, 9, 83408)),
    (4, 262144, 128, 75, dfa.Plan(1, 512, 512, 66, 9, 83408)),
    # rows of a width that is no multiple of 16 stay in global memory;
    # 144 bytes are 9 chunks, already odd
    (1, 4096, 40, 75, dfa.Plan(1, 512, 32, 128, 0, 9680)),
    (1, 4096, 144, 75, dfa.Plan(1, 512, 32, 128, 9, 14288)),
    # the widths: 256 states in uint8, 257 in uint16
    (1, 4096, 128, 256, dfa.Plan(1, 512, 32, 128, 9, 37632)),
    (1, 4096, 128, 257, dfa.Plan(2, 512, 32, 128, 9, 70672)),
    # the shared-memory edge on the H100: the half table of 904 states
    # fits (no room left for rows), of 905 does not
    (1, 4096, 128, 904, dfa.Plan(2, 512, 32, 128, 0, 232336)),
    (1, 4096, 128, 905, dfa.Plan(0, 32, 32, 128, 9, 4608)),
    (2, 262144, 128, 1024, dfa.Plan(0, 512, 512, 198, 9, 73728)),
    # long rows: the tile's rows and the table still fit
    (1, 4096, 4096, 75, dfa.Plan(1, 512, 32, 128, 257, 141264)),
    (1, 1, 128, 5, dfa.Plan(1, 512, 32, 1, 9, 5264)),
])
def test_plan(n_b, n_ids, width, states, want):
    got = dfa.plan(n_b, n_ids, width, states, H100)
    assert got == want
    assert got.branch == ("shared" if want.stored_width else "ldg")
    assert 32 <= got.ids <= got.threads <= 1024
    assert got.ids % 32 == 0 and got.threads % 32 == 0
    assert got.row_chunks == 0 or (got.row_chunks % 2 == 1
                                   and 16 * got.row_chunks >= width)
    assert got.smem <= H100.block_smem
    assert 1 <= got.blocks <= -(-n_ids // got.ids)


def test_plan_branch_is_set_by_states_alone():
    for states in list(range(1, 1025, 7)) + [904, 905]:
        branches = {dfa.plan(n_b, n_ids, width, states, H100).branch
                    for n_b in (1, 3) for n_ids in (1, 4096, 100000)
                    for width in (40, 128, 512)}
        assert branches == {"shared" if states <= 904 else "ldg"}, states


def test_wrapper_on_cpu_takes_the_plain_version():
    _name, trans, accept, sb, ok, xv, prefix = CASES[0]
    before = (dfa.dfa_table.plain_calls, dfa.dfa_table.launches,
              dfa.dfa_table_batched.plain_calls,
              dfa.dfa_table_batched.launches)
    ins = (torch.from_numpy(trans), torch.from_numpy(accept),
           torch.from_numpy(sb), torch.from_numpy(ok), torch.from_numpy(xv),
           prefix)
    got = dfa.dfa_table(*ins)
    gotb = dfa.dfa_table_batched(*(x[None] for x in ins[:5]), prefix)
    assert np.array_equal(got.numpy(), model_table(trans, accept, sb, ok,
                                                   xv, prefix))
    assert torch.equal(gotb[0], got)
    assert (dfa.dfa_table.plain_calls, dfa.dfa_table.launches,
            dfa.dfa_table_batched.plain_calls,
            dfa.dfa_table_batched.launches) == (
        before[0] + 1, before[1], before[2] + 1, before[3])


# -- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_k3_matches_plain_on_card(card, case):
    """Every case at every table width that holds its states; both
    branches (the cases run from 1 to 1,024 states); rows 16-byte
    aligned and (width 40, 100, or a view one byte in) not; the table
    16-byte aligned and a view one entry in."""
    _name, trans, accept, sb, ok, xv, prefix = case
    a, s, o, x = (torch.from_numpy(v).to(card) for v in (accept, sb, ok, xv))
    want = torch.from_numpy(model_table(trans, accept, sb, ok, xv, prefix))
    for dt in k3_dtypes(trans):
        t = torch.from_numpy(trans).to(dt).to(card)
        assert torch.equal(dfa.dfa_table_plain(t, a, s, o, x, prefix).cpu(),
                           want)
        for rows, table in ((s, t), (k3_shifted(s), t),
                            (s, k3_shifted(t))):
            got = dfa.dfa_table(table, a, rows, o, x, prefix)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (dt, rows is s, table is t)


@pytest.mark.cuda
@pytest.mark.parametrize("n_b", [1, 2, 3, 4])
@pytest.mark.parametrize("n_ids", [1, 100, 513, 4097])
@pytest.mark.parametrize("states,z_kind", [(75, "digest"), (3, "cycles"),
                                           (300, "fixed"), (1024, "fixed")])
def test_k3b_matches_plain_on_card(card, n_b, n_ids, states, z_kind):
    """K3b over N clusters' stacked tables (each its own DFA), ragged
    id counts, both branches."""
    rng = np.random.default_rng(n_b * 1000 + n_ids + states)
    tabs = [_library_dfa("@sha256:[a-f0-9]{64}$") if z_kind == "digest"
            else k3_synthetic_dfa(rng, states, z_kind == "cycles")
            for _ in range(n_b)]
    rows = [k3_rows(rng, n_ids, 128, 3, ALNUM) for _ in range(n_b)]
    trans = np.stack([t for t, _a in tabs])
    accept = np.stack([a for _t, a in tabs])
    sb, ok, xv = (np.stack([r[i] for r in rows]) for i in range(3))
    want = np.stack([model_table(trans[i], accept[i], sb[i], ok[i], xv[i], 3)
                     for i in range(n_b)])
    a, s, o, x = (torch.from_numpy(v).to(card) for v in (accept, sb, ok, xv))
    for dt in k3_dtypes(trans):
        t = torch.from_numpy(trans).to(dt).to(card)
        got = dfa.dfa_table_batched(t, a, s, o, x, 3)
        assert torch.equal(got, dfa.dfa_table_batched_plain(t, a, s, o, x, 3))
        assert np.array_equal(got.cpu().numpy(), want), dt


@pytest.mark.cuda
def test_k3_both_branches_on_card(card):
    """The plan sends 904 states to shared memory and 905 to the global
    table on an H100; either way the verdicts equal the plain scan's."""
    seen = set()
    rng = np.random.default_rng(7)
    for states in (904, 905):
        trans, accept = k3_synthetic_dfa(rng, states, False)
        sb, ok, xv = k3_rows(rng, 4096, 128, 3, bytes(range(1, 128)))
        t, a, s, o, x = (torch.from_numpy(v).to(card)
                         for v in (trans.astype(np.int16), accept, sb, ok, xv))
        seen.add(dfa.plan_for(t, s).branch)
        assert torch.equal(dfa.dfa_table(t, a, s, o, x, 3),
                           dfa.dfa_table_plain(t, a, s, o, x, 3))
    if dfa.limits(card).block_smem == H100.block_smem:
        assert seen == {"shared", "ldg"}


@pytest.mark.cuda
def test_k3_graph_replay_on_card(card):
    """K3 and K3b captured in a CUDA graph and replayed over new inputs
    written into the captured buffers."""
    rng = np.random.default_rng(9)
    trans, accept = _library_dfa("@sha256:[a-f0-9]{64}$")
    t, a = torch.from_numpy(trans).to(card), torch.from_numpy(accept).to(card)
    sb, ok, xv = k3_rows(rng, 4096, 128, 3, ALNUM)
    s, o, x = (torch.from_numpy(v).to(card) for v in (sb, ok, xv))
    tb, ab = t[None].repeat(2, 1, 1), a[None].repeat(2, 1)
    sb2, ob, xb = s[None].repeat(2, 1, 1), o[None].repeat(2, 1), \
        x[None].repeat(2, 1)
    dfa.dfa_table(t, a, s, o, x, 3)
    dfa.dfa_table_batched(tb, ab, sb2, ob, xb, 3)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dfa.dfa_table(t, a, s, o, x, 3)
        outb = dfa.dfa_table_batched(tb, ab, sb2, ob, xb, 3)
    for seed in range(3):
        r = np.random.default_rng(100 + seed)
        sb, ok, xv = k3_rows(r, 4096, 128, 3, ALNUM)
        for dst, src in ((s, sb), (o, ok), (x, xv)):
            dst.copy_(torch.from_numpy(src))
        sb2.copy_(s[None].expand_as(sb2))
        ob.copy_(o[None].expand_as(ob))
        xb.copy_(x[None].expand_as(xb))
        graph.replay()
        torch.cuda.synchronize()
        want = dfa.dfa_table_plain(t, a, s, o, x, 3)
        assert torch.equal(out, want)
        assert torch.equal(outb, torch.stack([want, want]))
