"""Known-column (program) opening recomputation.

The Rvm's program columns are part of the committed trace, but their
values are fixed by the verification program, which the outer verifier
holds. Binding: the verifier recomputes each known column's opening at
the out-of-domain points zeta and zeta*g directly from the program values
and asserts equality with the proof's openings — by Schwartz-Zippel the
committed polynomial then agrees with the program everywhere. This
replaces the reference's in-circuit constant gates / preprocessed
polynomials (plonky2 circuit constants) with a host-side check, which is
the natural split for this engine: FRI already binds the openings, so no
device work is added.

Evaluation is barycentric over the trace subgroup H = <g_n>:
    p(z) = (z^n - 1)/n * sum_i v_i * g^i / (z - g^i)
vectorized over numpy with the quadratic extension carried as a pair of
uint64 arrays (x^2 = 7, field/host.py:78).
"""

from __future__ import annotations

import numpy as np

from ..field import host, np_field

W_EXT = 7


def _e_inv(a0: np.ndarray, a1: np.ndarray):
    norm = np_field.sub(np_field.mul(a0, a0),
                        np_field.mul(np.uint64(W_EXT),
                                     np_field.mul(a1, a1)))
    ninv = np_field.inv(norm)
    return np_field.mul(a0, ninv), \
        np_field.sub(np.uint64(0), np_field.mul(a1, ninv))


def eval_known_at(values: np.ndarray, zeta: tuple[int, int],
                  cache: dict | None = None) -> tuple[int, int]:
    """Evaluate the interpolant of `values` (natural row order on H) at
    the extension point zeta. `cache` (keyed by (n, zeta)) reuses the
    per-point barycentric weights across columns."""
    n = len(values)
    key = (n, zeta)
    if cache is not None and key in cache:
        w0, w1 = cache[key]
    else:
        g = host.primitive_root_of_unity(n.bit_length() - 1)
        gs = np_field.powers(int(g), n)                 # g^i
        z0 = np.full(n, np.uint64(zeta[0] % host.P))
        z1 = np.full(n, np.uint64(zeta[1] % host.P))
        d0 = np_field.sub(z0, gs)                       # zeta - g^i
        d1 = z1
        i0, i1 = _e_inv(d0, d1)                         # 1/(zeta - g^i)
        w0 = np_field.mul(gs, i0)                       # g^i/(zeta - g^i)
        w1 = np_field.mul(gs, i1)
        zn = host.eexp(zeta, n)
        scale = host.escalar(host.esub(zn, (1, 0)), host.finv(n % host.P))
        # fold the (z^n - 1)/n factor into the weights (ext mul)
        t0 = np_field.add(
            np_field.mul(w0, np.uint64(scale[0])),
            np_field.mul(np.uint64(W_EXT),
                         np_field.mul(w1, np.uint64(scale[1]))))
        t1 = np_field.add(np_field.mul(w0, np.uint64(scale[1])),
                          np_field.mul(w1, np.uint64(scale[0])))
        w0, w1 = t0, t1
        if cache is not None:
            cache[key] = (w0, w1)
    v = values.astype(np.uint64)
    r0 = int(np_field.mul(w0, v).astype(object).sum() % host.P)
    r1 = int(np_field.mul(w1, v).astype(object).sum() % host.P)
    return (r0, r1)
