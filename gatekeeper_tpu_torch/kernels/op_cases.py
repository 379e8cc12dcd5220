"""Synthetic IR programs that exercise every op of the evaluator.

The library templates lower to a subset of the IR (no ``and``,
``any_e``/``all_e``/``count_e``, ``ptable_all``, ``cset_subset_memb``
or ``+ - *``).  :func:`every_op_case` builds one program that uses every
op, over random bindings made from a numpy seed with the prep naming
conventions, so the same inputs can go through the reference
evaluator, the plain torch evaluator and K1.  Pure numpy + the port's
IR dataclasses: no torch, no device.
"""

from __future__ import annotations

import numpy as np

from gatekeeper_tpu_torch.ir.program import Node, Program, RuleSpec


def every_op_case(seed: int, c_pad: int = 8, r_pad: int = 64, e_pad: int = 4,
                  t_pad: int = 32, u: int = 8, l_keys: int = 5,
                  n_states: int = 6, width: int = 16):
    """(program, arrays) with every IR op, random bindings."""
    rng = np.random.default_rng(seed)

    def ids(shape, hi):
        # -1 = MISSING, plus out-of-range ids to exercise the clamps
        return rng.integers(-1, hi + 3, size=shape).astype(np.int32)

    def flags(shape, p=0.5):
        return rng.random(shape) < p

    def nums(shape):
        v = rng.choice(np.array([0.0, 1.0, -2.5, 3.0, 0.5, 7.0, -0.0],
                                dtype=np.float32), size=shape)
        return v.astype(np.float32)

    A: dict[str, np.ndarray] = {
        "__alive__": flags((r_pad,), 0.9),
        "__cvalid__": flags((c_pad,), 0.9),
        "__match__": flags((c_pad, r_pad), 0.8),
        "__elem__:ax": flags((r_pad, e_pad), 0.6),
        "r:a.v": nums((r_pad,)), "r:a.p": flags((r_pad,), 0.8),
        "r:b.v": nums((r_pad,)), "r:b.p": flags((r_pad,), 0.8),
        "r:i": ids((r_pad,), t_pad),
        "r:f": flags((r_pad,)),
        "e:x.v": nums((r_pad, e_pad)), "e:x.p": flags((r_pad, e_pad), 0.8),
        "e:s": ids((r_pad, e_pad), t_pad),
        "e:f": flags((r_pad, e_pad)),
        "cv0.v": nums((c_pad,)), "cv0.p": flags((c_pad,), 0.8),
        "cv1": ids((c_pad,), t_pad),
        "cb0": flags((c_pad,)),
        "t0.ok": flags((t_pad,), 0.7), "t0.v": nums((t_pad,)),
        "t1.ok": flags((t_pad,), 0.7), "t1.v": flags((t_pad,)),
        "pt0.vmap": rng.integers(0, u - 1, size=(t_pad,)).astype(np.int32),
        "pt0.any": flags((c_pad, u)), "pt0.all": flags((c_pad, u)),
        "cs0.vmap": rng.integers(0, u - 1, size=(t_pad,)).astype(np.int32),
        "cs0.bitmap": flags((c_pad, u)),
        "cs1.B": flags((c_pad, l_keys), 0.3),
        "m1": flags((l_keys, r_pad), 0.7),
        "cs2.B": flags((c_pad, l_keys), 0.3),
        "ek0": flags((l_keys, r_pad, e_pad), 0.7),
        "kl0.kv": ids((l_keys, r_pad), t_pad),
        "kl0.sel": rng.integers(-1, l_keys + 1,
                                size=(c_pad,)).astype(np.int32),
        "__strbytes__": rng.integers(0, 128, size=(t_pad, width))
        .astype(np.uint8),
        "__strdfaok__": flags((t_pad,), 0.8),
        "dfa0.trans": rng.integers(0, n_states, size=(n_states, 256))
        .astype(np.int32),
        "dfa0.accept": flags((n_states,)),
        "dfa0.xv": flags((t_pad,)),
    }
    N: list[Node] = []

    def add(op, args=(), meta=()):
        N.append(Node(op, tuple(args), tuple(meta)))
        return len(N) - 1

    ra = add("input", meta=("r:a", "r_num"))
    rb = add("input", meta=("r:b", "r_num"))
    ri = add("input", meta=("r:i", "r_id"))
    rf = add("input", meta=("r:f", "r_bool"))
    ex = add("input", meta=("e:x", "e_num"))
    es = add("input", meta=("e:s", "e_id"))
    ef = add("input", meta=("e:f", "e_bool"))
    c0 = add("input", meta=("cv0", "c_num"))
    c1 = add("input", meta=("cv1", "c_id"))
    cb = add("input", meta=("cb0", "c_bool"))
    k_half = add("const", meta=(0.5, "float32"))
    k_true = add("const", meta=(True, "bool"))
    tab = add("table", (ri,), ("t0",))
    tab_b = add("table", (es,), ("t1",))
    dfa = add("dfa_match", (ri,), ("dfa0",))
    pany = add("ptable_any", (es,), ("pt0", "pt0"))
    pall = add("ptable_all", (ri,), ("pt0", "pt0"))
    kv = add("keyed_val", (), ("kl0",))
    ics = add("in_cset", (es,), ("cs0",))
    ics_c = add("in_cset", (kv,), ("cs0",))
    nsub = add("cset_not_subset_memb", (), ("cs1", "m1"))
    sub = add("cset_subset_memb", (), ("cs1", "m1"))
    ekm = add("elem_keys_missing", (), ("cs2", "ek0"))
    cmps = [add("cmp", (x, y), (op,)) for x, y, op in (
        (ra, rb, "=="), (ra, c0, "!="), (ex, k_half, "<"), (tab, ra, "<="),
        (ra, ex, ">"), (c0, ex, ">="), (ri, c1, "=="), (rf, ef, "<"),
        (tab_b, k_true, "=="))]
    plus = add("arith", (ra, ex), ("+",))
    minus = add("arith", (c0, rb), ("-",))
    times = add("arith", (ex, c0), ("*",))
    div = add("arith", (ra, ex), ("/",))
    div0 = add("arith", (k_half, rb), ("/",))
    arith_cmp = [add("cmp", (plus, times), (">",)),
                 add("cmp", (div, minus), ("<",)),
                 add("cmp", (div0, k_half), (">=",))]
    anye = add("any_e", (cmps[2],), ("ax",))
    alle = add("all_e", (ef,), ("ax",))
    cnte = add("count_e", (ics,), ("ax",))
    cnt_cmp = add("cmp", (cnte, c0), (">",))
    a1 = add("and", (dfa, cb))
    o1 = add("or", (pany, ekm))
    n1 = add("not", (sub,))
    rules = (
        RuleSpec((a1, cmps[0], cmps[1])),
        RuleSpec((o1, cmps[2], cmps[4], arith_cmp[0]), elem_axis="ax"),
        RuleSpec((pall, cmps[3], ics_c, nsub)),
        RuleSpec((anye, alle, cnt_cmp, cmps[5])),
        RuleSpec((n1, cmps[6], cmps[7], arith_cmp[1], cmps[8])),
        RuleSpec((arith_cmp[2], tab_b, ef, rf), elem_axis="ax"),
        RuleSpec((kv, ri, es)),
    )
    return Program(nodes=tuple(N), rules=rules), A


def stacked_every_op_case(n: int, seed: int = 40, c_pad: int = 8,
                          r_pad: int = 32, t_pad: int = 16, u: int = 4,
                          n_states: int = 5):
    """(program, stacked): ``n`` every-op cases of ragged sizes (the
    cluster i case has R_pad ``r_pad << i % 3``, T ``t_pad << i % 2``, U
    ``u + 2i`` and ``n_states + i`` DFA states), each with a permuted
    ``__rank__`` padded as the fleet pads it, stacked along a leading
    cluster axis exactly as ``whatif/fleet.fleet_audit`` stacks bindings
    (zero fill; edge fill for ``.any``/``.all``/``.bitmap``)."""
    from gatekeeper_tpu_torch.whatif.fleet import _EDGE_PAD_SUFFIXES, _pad_to
    per = []
    for i in range(n):
        prog, arrays = every_op_case(seed + i, c_pad=c_pad,
                                     r_pad=r_pad << (i % 3),
                                     t_pad=t_pad << (i % 2), u=u + 2 * i,
                                     n_states=n_states + i)
        rng = np.random.default_rng(seed + 1000 + i)
        rp = arrays["__alive__"].shape[0]
        rank = np.full((rp,), rp - 1, dtype=np.int32)
        live = rp - 3
        rank[:live] = rng.permutation(live).astype(np.int32)
        arrays["__rank__"] = rank
        per.append(arrays)
    stacked = {}
    for nm in sorted(per[0]):
        arrs = [a[nm] for a in per]
        shape = tuple(max(s) for s in zip(*[x.shape for x in arrs]))
        edge = nm.endswith(_EDGE_PAD_SUFFIXES)
        stacked[nm] = np.stack([_pad_to(x, shape, edge) for x in arrs])
    return prog, stacked


def ordering_case(seed: int, c_pad: int = 8, r_pad: int = 64,
                  e_pad: int = 4):
    """(program, arrays): one rule per ordering compare of a row or
    element value against a constraint value (both operand orders;
    float, narrowed-id and bool operands), with NaN, infinities and
    signed zeros among the floats — the rules K1's emitter evaluates
    through the max / min over the element axis."""
    rng = np.random.default_rng(seed)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -2.5,
                        3e38, -3e38, 0.5], dtype=np.float32)

    def nums(shape):
        return rng.choice(special, size=shape).astype(np.float32)

    def flags(shape, p=0.7):
        return rng.random(shape) < p

    A = {
        "__alive__": flags((r_pad,), 0.9),
        "__cvalid__": flags((c_pad,), 0.9),
        "__elem__:ax": flags((r_pad, e_pad), 0.6),
        "e:x.v": nums((r_pad, e_pad)), "e:x.p": flags((r_pad, e_pad)),
        "e:s": rng.integers(-1, 9, size=(r_pad, e_pad)).astype(np.int32),
        "e:f": flags((r_pad, e_pad), 0.5),
        "r:y.v": nums((r_pad,)), "r:y.p": flags((r_pad,)),
        "cv0.v": nums((c_pad,)), "cv0.p": flags((c_pad,)),
        "cv1": rng.integers(-1, 9, size=(c_pad,)).astype(np.int32),
        "cb0": flags((c_pad,), 0.5),
    }
    N: list[Node] = []

    def add(op, args=(), meta=()):
        N.append(Node(op, tuple(args), tuple(meta)))
        return len(N) - 1

    ex = add("input", meta=("e:x", "e_num"))
    es = add("input", meta=("e:s", "e_id"))
    ef = add("input", meta=("e:f", "e_bool"))
    ry = add("input", meta=("r:y", "r_num"))
    c0 = add("input", meta=("cv0", "c_num"))
    c1 = add("input", meta=("cv1", "c_id"))
    cb = add("input", meta=("cb0", "c_bool"))
    rules = []
    for op in ("<", "<=", ">", ">="):
        for x, y, axis in ((ex, c0, "ax"), (c0, ex, "ax"), (ry, c0, None),
                           (es, c1, "ax"), (c1, es, None), (ef, cb, "ax")):
            rules.append(RuleSpec((add("cmp", (x, y), (op,)),),
                                  elem_axis=axis))
    # one beside other conjuncts: a row compare and a constraint flag
    rules.append(RuleSpec((add("cmp", (ex, c0), (">",)),
                           add("cmp", (ry, ex), ("<",)), cb),
                          elem_axis="ax"))
    return Program(nodes=tuple(N), rules=tuple(rules)), A
