"""A plain halo2 verifier (zcash halo2_proofs 0.3, IPA over Pallas) that
judges the proofs a run produced.

It works out again, from a circuit's plain description, what keygen and
`Params` derive: the SRS (pasta.py), the fixed and permutation
commitments, the pinned verification key and its transcript hash. It then
replays each proof's Blake2b transcript, evaluates every gate, the
permutation and lookup arguments and the vanishing argument at x,
combines the openings as halo2's multiopen does and checks the IPA
opening. The openings of many proofs are checked together: each proof's
final multi-scalar product is scaled by a random factor and the sum must
be the identity (halo2's BatchVerifier). Plain Python integers; nothing
here imports torch or the program under test.

A circuit description is a dict (see plonk_bench.py, dev_lookup.py):
  k, num_fixed, num_advice, num_instance, num_selectors,
  advice_queries / instance_queries / fixed_queries: [(column, rotation)],
  gates: [expression], lookups: [([input expr], [table expr])],
  permutation: [(kind, column)] with kind "advice", "fixed" or "instance",
  fixed: the fixed columns' values on rows 0 .. 2^k - 1,
  copies: [((perm column, row), (perm column, row))] in keygen's order,
  and optionally minimum_degree (set_minimum_degree's argument).
An expression is a nested tuple: ("fixed" | "advice" | "instance",
query index, column index, rotation), ("constant", v), ("negated", e),
("sum", a, b), ("product", a, b) or ("scaled", e, v).
"""
from __future__ import annotations

import hashlib
import os
import random

from . import pasta
from .pasta import P, Q

_KIND = {"advice": "Advice", "fixed": "Fixed", "instance": "Instance"}


class Rejected(Exception):
    """The proof does not verify; the message says where."""


# ---- the constraint system's derived sizes

def expr_degree(e) -> int:
    tag = e[0]
    if tag in _KIND:
        return 1
    if tag == "constant":
        return 0
    if tag in ("negated", "scaled"):
        return expr_degree(e[1])
    if tag == "sum":
        return max(expr_degree(e[1]), expr_degree(e[2]))
    if tag == "product":
        return expr_degree(e[1]) + expr_degree(e[2])
    raise ValueError(tag)


def cs_degree(cs) -> int:
    degree = 3                                  # the permutation argument
    for inputs, tables in cs["lookups"]:
        i = max([1] + [expr_degree(e) for e in inputs])
        t = max([1] + [expr_degree(e) for e in tables])
        degree = max(degree, 4, 2 + i + t)
    for gate in cs["gates"]:
        degree = max(degree, expr_degree(gate))
    return max(degree, cs.get("minimum_degree") or 1)


def blinding_factors(cs) -> int:
    per_column = [0] * cs["num_advice"]
    for column, _ in cs["advice_queries"]:
        per_column[column] += 1
    return max(3, max(per_column, default=1)) + 2


def domain(cs) -> dict:
    k = cs["k"]
    quotient_degree = cs_degree(cs) - 1
    extended_k = k
    while (1 << extended_k) < (1 << k) * quotient_degree:
        extended_k += 1
    omega = pow(pasta.Q_ROOT, 1 << (pasta.S - k), Q)
    return {"k": k, "n": 1 << k, "extended_k": extended_k, "omega": omega,
            "omega_inv": pow(omega, Q - 2, Q),
            "quotient_degree": quotient_degree}


# ---- the pinned verification key, as Rust's derived Debug prints it

def _fe(v: int) -> str:
    return f"0x{v:064x}"


def _point(pt) -> str:
    return "Infinity" if pt is None else f"({_fe(pt[0])}, {_fe(pt[1])})"


def _column(kind: str, index: int) -> str:
    return f"Column {{ index: {index}, column_type: {_KIND[kind]} }}"


def _expr(e) -> str:
    tag = e[0]
    if tag in _KIND:
        _, qi, ci, rot = e
        return (f"{_KIND[tag]} {{ query_index: {qi}, column_index: {ci}, "
                f"rotation: Rotation({rot}) }}")
    if tag == "constant":
        return f"Constant({_fe(e[1])})"
    if tag == "negated":
        return f"Negated({_expr(e[1])})"
    if tag == "sum":
        return f"Sum({_expr(e[1])}, {_expr(e[2])})"
    if tag == "product":
        return f"Product({_expr(e[1])}, {_expr(e[2])})"
    if tag == "scaled":
        return f"Scaled({_expr(e[1])}, {_fe(e[2])})"
    raise ValueError(tag)


def _queries(kind: str, queries) -> str:
    return "[" + ", ".join(f"({_column(kind, c)}, Rotation({r}))"
                           for c, r in queries) + "]"


def pinned_text(cs, fixed_commitments, permutation_commitments) -> str:
    d = domain(cs)
    lookups = ", ".join(
        "Argument { input_expressions: [" + ", ".join(map(_expr, i))
        + "], table_expressions: [" + ", ".join(map(_expr, t)) + "] }"
        for i, t in cs["lookups"])
    perm = ", ".join(_column(kind, c) for kind, c in cs["permutation"])
    minimum = cs.get("minimum_degree")
    minimum = "None" if minimum is None else f"Some({minimum})"
    return (
        f'PinnedVerificationKey {{ base_modulus: "{_fe(P)}", '
        f'scalar_modulus: "{_fe(Q)}", domain: PinnedEvaluationDomain {{ '
        f'k: {d["k"]}, extended_k: {d["extended_k"]}, omega: {_fe(d["omega"])} }}, '
        f"cs: PinnedConstraintSystem {{ num_fixed_columns: {cs['num_fixed']}, "
        f"num_advice_columns: {cs['num_advice']}, "
        f"num_instance_columns: {cs['num_instance']}, "
        f"num_selectors: {cs['num_selectors']}, "
        f"gates: [{', '.join(map(_expr, cs['gates']))}], "
        f"advice_queries: {_queries('advice', cs['advice_queries'])}, "
        f"instance_queries: {_queries('instance', cs['instance_queries'])}, "
        f"fixed_queries: {_queries('fixed', cs['fixed_queries'])}, "
        f"permutation: Argument {{ columns: [{perm}] }}, "
        f"lookups: [{lookups}], constants: [], minimum_degree: {minimum} }}, "
        f"fixed_commitments: [{', '.join(map(_point, fixed_commitments))}], "
        f"permutation: VerifyingKey {{ commitments: "
        f"[{', '.join(map(_point, permutation_commitments))}] }} }}")


def transcript_repr(text: str) -> int:
    h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
    data = text.encode()
    h.update(len(data).to_bytes(8, "little"))
    h.update(data)
    return int.from_bytes(h.digest(), "little") % Q


# ---- keygen's permutation: halo2's union of cycles (permutation/keygen.rs)

def permutation_values(cs) -> list[list[int]]:
    """sigma_i(omega^j) = delta^i' omega^j' where (i', j') follows (i, j)
    in its cycle, the cycles built copy by copy as keygen builds them."""
    n = 1 << cs["k"]
    m = len(cs["permutation"])
    mapping = [[(i, j) for j in range(n)] for i in range(m)]
    aux = [[(i, j) for j in range(n)] for i in range(m)]
    sizes = [[1] * n for _ in range(m)]
    for (lc, lr), (rc, rr) in cs["copies"]:
        left, right = aux[lc][lr], aux[rc][rr]
        if left == right:
            continue
        if sizes[left[0]][left[1]] < sizes[right[0]][right[1]]:
            left, right = right, left
        sizes[left[0]][left[1]] += sizes[right[0]][right[1]]
        cell = right
        while True:
            aux[cell[0]][cell[1]] = left
            cell = mapping[cell[0]][cell[1]]
            if cell == right:
                break
        mapping[lc][lr], mapping[rc][rr] = mapping[rc][rr], mapping[lc][lr]
    omega = domain(cs)["omega"]
    omegas = [1] * n
    for j in range(1, n):
        omegas[j] = omegas[j - 1] * omega % Q
    deltas = [pow(pasta.Q_DELTA, i, Q) for i in range(m)]
    return [[deltas[i2] * omegas[j2] % Q for i2, j2 in mapping[i]]
            for i in range(m)]


# ---- the verifying key, worked out again and cached

class Srs:
    """g_0 .. g_{2^k - 1} in a file (made on first use), w and u."""

    def __init__(self, cache_dir: str, k: int, workers: int):
        os.makedirs(cache_dir, exist_ok=True)
        self.k, self.n, self.workers = k, 1 << k, workers
        self.path = os.path.join(cache_dir, f"pallas_g_k{k}.bin")
        if not os.path.exists(self.path):
            pasta.make_srs(self.path, k, workers)
        self.w, self.u = pasta.srs_w_u()

    def commit(self, coeffs: list[int], blind: int = 1):
        """<coeffs, g> + blind w."""
        return pasta.add(pasta.msm_file_points(coeffs, self.path, self.workers),
                         pasta.mul(blind, self.w))

    def commit_lagrange(self, values: list[int], blind: int = 1):
        return self.commit(pasta.intt(values, self.k), blind)


def _hex_point(pt):
    return None if pt is None else [f"{pt[0]:x}", f"{pt[1]:x}"]


def _unhex_point(v):
    return None if v is None else (int(v[0], 16), int(v[1], 16))


def verifying_key(cs, srs: Srs, cache_path: str) -> dict:
    """Fixed commitments, permutation commitments, the commitments of the
    Lagrange basis at the instance rows, the pinned text and its hash.
    Seed-independent: read from `cache_path` after the first run."""
    import json
    if os.path.exists(cache_path):
        with open(cache_path) as fh:
            raw = json.load(fh)
        vk = {key: [_unhex_point(v) for v in raw[key]]
              for key in ("fixed", "permutation", "lagrange")}
    else:
        n = 1 << cs["k"]
        omega_inv = domain(cs)["omega_inv"]
        n_inv = pow(n, Q - 2, Q)
        lagrange = []
        for j in range(cs["instance_rows"]):
            # L_j(X) = (1/n) sum_i omega^(-ij) X^i
            step = pow(omega_inv, j, Q)
            coeffs, cur = [0] * n, n_inv
            for i in range(n):
                coeffs[i] = cur
                cur = cur * step % Q
            lagrange.append(pasta.msm_file_points(coeffs, srs.path,
                                                  srs.workers))
        vk = {"fixed": [srs.commit_lagrange(col) for col in cs["fixed"]],
              "permutation": [srs.commit_lagrange(col)
                              for col in permutation_values(cs)],
              "lagrange": lagrange}
        tmp = cache_path + ".partial"
        with open(tmp, "w") as fh:
            json.dump({key: [_hex_point(p) for p in vk[key]] for key in vk}, fh)
        os.replace(tmp, cache_path)
    vk["pinned"] = pinned_text(cs, vk["fixed"], vk["permutation"])
    vk["repr"] = transcript_repr(vk["pinned"])
    return vk


# ---- the transcript (halo2_proofs transcript.rs: Blake2b-512)

class Transcript:
    def __init__(self, proof: bytes):
        self.state = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")
        self.proof, self.pos = proof, 0

    def common_point(self, pt) -> None:
        if pt is None:
            raise Rejected("the identity in the transcript")
        self.state.update(b"\x01" + pt[0].to_bytes(32, "little")
                          + pt[1].to_bytes(32, "little"))

    def common_scalar(self, v: int) -> None:
        self.state.update(b"\x02" + v.to_bytes(32, "little"))

    def challenge(self) -> int:
        self.state.update(b"\x00")
        return int.from_bytes(self.state.copy().digest(), "little") % Q

    def _take(self) -> bytes:
        data = self.proof[self.pos:self.pos + 32]
        if len(data) != 32:
            raise Rejected("the proof ends early")
        self.pos += 32
        return data

    def point(self):
        pt = pasta.from_bytes(self._take())
        if pt is False:
            raise Rejected("a point that is not on the curve")
        self.common_point(pt)
        return pt

    def scalar(self) -> int:
        v = int.from_bytes(self._take(), "little")
        if v >= Q:
            raise Rejected("a scalar that is not reduced")
        self.common_scalar(v)
        return v

    def points(self, count: int) -> list:
        return [self.point() for _ in range(count)]

    def scalars(self, count: int) -> list[int]:
        return [self.scalar() for _ in range(count)]


# ---- verification

def _eval(e, advice, fixed, instance) -> int:
    tag = e[0]
    if tag == "advice":
        return advice[e[1]]
    if tag == "fixed":
        return fixed[e[1]]
    if tag == "instance":
        return instance[e[1]]
    if tag == "constant":
        return e[1] % Q
    if tag == "negated":
        return -_eval(e[1], advice, fixed, instance) % Q
    if tag == "sum":
        return (_eval(e[1], advice, fixed, instance)
                + _eval(e[2], advice, fixed, instance)) % Q
    if tag == "product":
        return (_eval(e[1], advice, fixed, instance)
                * _eval(e[2], advice, fixed, instance)) % Q
    if tag == "scaled":
        return _eval(e[1], advice, fixed, instance) * e[2] % Q
    raise ValueError(tag)


def _rotate(d, x: int, rot: int) -> int:
    if rot >= 0:
        return x * pow(d["omega"], rot, Q) % Q
    return x * pow(d["omega_inv"], -rot, Q) % Q


class Opening:
    """What is left of one proof once its transcript has been replayed:
    terms (scalar, point) whose sum, with -c <s(u), g> and the constant
    g_0 term, must be the identity."""

    def __init__(self, terms, g0: int, neg_c: int, u: list[int]):
        self.terms, self.g0, self.neg_c, self.u = terms, g0, neg_c, u


def _scale(terms, factor: int):
    return [(s * factor % Q, pt) for s, pt in terms]


def replay(cs, vk: dict, srs: Srs, instances: list[list[list[int]]],
           proof: bytes) -> Opening:
    """plonk/verifier.rs for a proof of len(instances) circuits, each
    with its instance columns; raises Rejected."""
    d = domain(cs)
    n, k = d["n"], d["k"]
    bf = blinding_factors(cs)
    tr = Transcript(proof)
    tr.common_scalar(vk["repr"])
    inst_c = []
    for instance in instances:
        if len(instance) != cs["num_instance"]:
            raise Rejected("the wrong number of instance columns")
        commitments = []
        for values in instance:
            if len(values) > min(n - (bf + 1), len(vk["lagrange"])):
                raise Rejected("too many public inputs")
            acc = pasta.jac(srs.w)                       # the default blind
            for v, base in zip(values, vk["lagrange"]):
                acc = pasta.jadd(acc, pasta.jac(pasta.mul(v, base)))
            commitments.append(pasta.affine(acc))
        inst_c.append(commitments)
    for commitments in inst_c:
        for pt in commitments:
            tr.common_point(pt)
    m = len(instances)
    lookups = cs["lookups"]
    advice_c = [tr.points(cs["num_advice"]) for _ in range(m)]
    theta = tr.challenge()
    permuted = [[(tr.point(), tr.point()) for _ in lookups] for _ in range(m)]
    beta = tr.challenge()
    gamma = tr.challenge()
    chunk = cs_degree(cs) - 2
    columns = cs["permutation"]
    n_sets = -(-len(columns) // chunk)
    perm_c = [tr.points(n_sets) for _ in range(m)]
    product_c = [[tr.point() for _ in lookups] for _ in range(m)]
    random_c = tr.point()
    y = tr.challenge()
    h_c = tr.points(d["quotient_degree"])
    x = tr.challenge()
    instance_e = [tr.scalars(len(cs["instance_queries"])) for _ in range(m)]
    advice_e = [tr.scalars(len(cs["advice_queries"])) for _ in range(m)]
    fixed_e = tr.scalars(len(cs["fixed_queries"]))
    random_e = tr.scalar()
    common_e = tr.scalars(len(columns))
    sets = []
    for _ in range(m):
        per = []
        for i in range(n_sets):
            ev, ev_next = tr.scalar(), tr.scalar()
            per.append((ev, ev_next, tr.scalar() if i < n_sets - 1 else None))
        sets.append(per)
    lookup_e = [[tr.scalars(5) for _ in lookups] for _ in range(m)]

    # ---- the expected h(x)
    xn = pow(x, n, Q)
    common = (xn - 1) * pow(n, Q - 2, Q) % Q
    l_evals = []
    for rot in range(-(bf + 1), 1):
        point = _rotate(d, 1, rot)
        l_evals.append(_rotate(d, pow((x - point) % Q, Q - 2, Q) * common % Q,
                               rot))
    l_last, l_0 = l_evals[0], l_evals[-1]
    l_blind = sum(l_evals[1:1 + bf]) % Q
    active = (1 - l_last - l_blind) % Q

    exprs = []
    for c in range(m):
        adv, ins = advice_e[c], instance_e[c]
        evals = {"advice": adv, "fixed": fixed_e, "instance": ins}

        def column_eval(kind, column):
            return evals[kind][cs[kind + "_queries"].index((column, 0))]

        def compress(exs):
            acc = 0
            for e in exs:
                acc = (acc * theta + _eval(e, adv, fixed_e, ins)) % Q
            return acc

        exprs += [_eval(g, adv, fixed_e, ins) for g in cs["gates"]]
        per = sets[c]
        if per:
            exprs.append(l_0 * (1 - per[0][0]) % Q)
            exprs.append((per[-1][0] * per[-1][0] - per[-1][0]) * l_last % Q)
            for prev, cur in zip(per, per[1:]):
                exprs.append((cur[0] - prev[2]) * l_0 % Q)
            for ci, start in enumerate(range(0, len(columns), chunk)):
                left, right = per[ci][1], per[ci][0]
                cur_delta = beta * x % Q * pow(pasta.Q_DELTA, start, Q) % Q
                for (kind, column), perm_eval in zip(
                        columns[start:start + chunk], common_e[start:]):
                    ev = column_eval(kind, column)
                    left = left * ((ev + beta * perm_eval + gamma) % Q) % Q
                    right = right * ((ev + cur_delta + gamma) % Q) % Q
                    cur_delta = cur_delta * pasta.Q_DELTA % Q
                exprs.append((left - right) * active % Q)
        for (inputs, tables), ev in zip(lookups, lookup_e[c]):
            z, z_next, a_p, a_prev, s_p = ev
            left = z_next * ((a_p + beta) % Q) % Q * ((s_p + gamma) % Q) % Q
            right = (z * ((compress(inputs) + beta) % Q) % Q
                     * ((compress(tables) + gamma) % Q) % Q)
            exprs += [l_0 * (1 - z) % Q, l_last * (z * z - z) % Q,
                      (left - right) * active % Q, l_0 * (a_p - s_p) % Q,
                      (a_p - s_p) * (a_p - a_prev) % Q * active % Q]
    h_eval = 0
    for v in exprs:
        h_eval = (h_eval * y + v) % Q
    h_eval = h_eval * pow((xn - 1) % Q, Q - 2, Q) % Q
    h_terms, power = [], 1
    for hc in h_c:                             # sum xn^i h_i
        h_terms.append((power, hc))
        power = power * xn % Q

    # ---- the queries, in the verifier's order (the key names the
    # commitment: a commitment queried at several points groups together)
    queries = []      # (key, point, terms, eval)
    x_next, x_inv = _rotate(d, x, 1), _rotate(d, x, -1)
    x_last = _rotate(d, x, -(bf + 1))
    for c in range(m):
        for qi, (column, rot) in enumerate(cs["instance_queries"]):
            queries.append((("instance", c, column), _rotate(d, x, rot),
                            [(1, inst_c[c][column])], instance_e[c][qi]))
        for qi, (column, rot) in enumerate(cs["advice_queries"]):
            queries.append((("advice", c, column), _rotate(d, x, rot),
                            [(1, advice_c[c][column])], advice_e[c][qi]))
        for i, (pc, (ev, ev_next, _)) in enumerate(zip(perm_c[c], sets[c])):
            queries.append((("z", c, i), x, [(1, pc)], ev))
            queries.append((("z", c, i), x_next, [(1, pc)], ev_next))
        for i in range(n_sets - 2, -1, -1):
            queries.append((("z", c, i), x_last, [(1, perm_c[c][i])],
                            sets[c][i][2]))
        for i, ((pi, pt), pz, ev) in enumerate(zip(permuted[c], product_c[c],
                                                   lookup_e[c])):
            z, z_next, a_p, a_prev, s_p = ev
            queries += [(("lz", c, i), x, [(1, pz)], z),
                        (("la", c, i), x, [(1, pi)], a_p),
                        (("ls", c, i), x, [(1, pt)], s_p),
                        (("la", c, i), x_inv, [(1, pi)], a_prev),
                        (("lz", c, i), x_next, [(1, pz)], z_next)]
    for qi, (column, rot) in enumerate(cs["fixed_queries"]):
        queries.append((("fixed", column), _rotate(d, x, rot),
                        [(1, vk["fixed"][column])], fixed_e[qi]))
    for i, (pc, ev) in enumerate(zip(vk["permutation"], common_e)):
        queries.append((("sigma", i), x, [(1, pc)], ev))
    queries.append((("h",), x, h_terms, h_eval))
    queries.append((("random",), x, [(1, random_c)], random_e))

    # ---- multiopen (multiopen.rs, multiopen/verifier.rs)
    x1, x2 = tr.challenge(), tr.challenge()
    point_index, keys = {}, {}
    for key, point, terms, ev in queries:
        point_index.setdefault(point, len(point_index))
        keys.setdefault(key, {"terms": terms, "points": []})
        keys[key]["points"].append(point_index[point])
    points_of = {v: p for p, v in point_index.items()}
    set_index = {}
    for data in keys.values():
        data["set"] = tuple(sorted(set(data["points"])))
        set_index.setdefault(data["set"], len(set_index))
        data["evals"] = [None] * len(data["set"])
    for key, point, terms, ev in queries:
        data = keys[key]
        pos = data["set"].index(point_index[point])
        if data["evals"][pos] is None:
            data["evals"][pos] = ev
        elif data["evals"][pos] != ev:
            raise Rejected("two evaluations of one commitment at one point")
    point_sets = [None] * len(set_index)
    for s, i in set_index.items():
        point_sets[i] = [points_of[j] for j in s]
    q_terms = [[] for _ in point_sets]
    q_evals = [[0] * len(ps) for ps in point_sets]
    powers = [1] * len(point_sets)
    for data in reversed(list(keys.values())):
        si = set_index[data["set"]]
        q_terms[si] += _scale(data["terms"], powers[si])
        for i, ev in enumerate(data["evals"]):
            q_evals[si][i] = (q_evals[si][i] + ev * powers[si]) % Q
        powers[si] = powers[si] * x1 % Q
    f_c = tr.point()
    x3 = tr.challenge()
    u_evals = tr.scalars(len(point_sets))
    msm_eval = 0
    for points, evals, proof_eval in zip(point_sets, q_evals, u_evals):
        r_eval = 0                       # the interpolant of evals at x3
        for i, (pi, ei) in enumerate(zip(points, evals)):
            num = den = 1
            for j, pj in enumerate(points):
                if j != i:
                    num = num * (x3 - pj) % Q
                    den = den * (pi - pj) % Q
            r_eval = (r_eval + ei * num * pow(den, Q - 2, Q)) % Q
        ev = (proof_eval - r_eval) % Q
        for point in points:
            ev = ev * pow((x3 - point) % Q, Q - 2, Q) % Q
        msm_eval = (msm_eval * x2 + ev) % Q
    x4 = tr.challenge()
    terms, v = [(1, f_c)], msm_eval
    for qt, q_eval in zip(q_terms, u_evals):
        terms = _scale(terms, x4) + qt
        v = (v * x4 + q_eval) % Q

    # ---- the IPA opening (commitment/verifier.rs)
    s_c = tr.point()
    xi = tr.challenge()
    terms.append((xi, s_c))
    z = tr.challenge()
    u = []
    for _ in range(k):
        l_pt, r_pt = tr.point(), tr.point()
        u_j = tr.challenge()
        if u_j == 0:
            raise Rejected("a zero round challenge")
        terms += [(pow(u_j, Q - 2, Q), l_pt), (u_j, r_pt)]
        u.append(u_j)
    c = tr.scalar()
    f = tr.scalar()
    if tr.pos != len(proof):
        raise Rejected("bytes after the proof")
    b, cur = 1, x3
    for u_j in reversed(u):
        b = b * (1 + u_j * cur) % Q
        cur = cur * cur % Q
    neg_c = -c % Q
    terms += [(neg_c * b % Q * z % Q, srs.u), (-f % Q, srs.w)]
    return Opening(terms, -v % Q, neg_c, u)


def add_s(acc: list[int], u: list[int], init: int) -> None:
    """acc += init * s(u): the coefficients of prod (1 + u_{k-1-i} X^(2^i))."""
    s = [init % Q]
    for u_j in reversed(u):
        s += [v * u_j % Q for v in s]
    for i, v in enumerate(s):
        acc[i] += v


def check_openings(srs: Srs, openings: list[Opening], seed: int) -> bool:
    """True iff the random combination of the openings is the identity."""
    rng = random.Random(f"{seed}:batch")
    g_scalars = [0] * srs.n
    terms = []
    for op in openings:
        alpha = rng.getrandbits(512) % Q
        terms += _scale(op.terms, alpha)
        g_scalars[0] += op.g0 * alpha
        add_s(g_scalars, op.u, op.neg_c * alpha)
    g_part = pasta.msm_file_points([v % Q for v in g_scalars], srs.path,
                                   srs.workers)
    small = pasta.msm([s for s, _ in terms], [pt for _, pt in terms])
    return pasta.add(g_part, small) is None
