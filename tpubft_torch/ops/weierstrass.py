"""Short-Weierstrass curve ops (y^2 = x^3 + ax + b) over a torch Field: the
plain PyTorch counterpart of tpubft/ops/weierstrass.py::Curve, written
for the port.

The complete projective addition law (Renes-Costello-Batina closed form,
the reference's weierstrass.py:58-99): one branch-free formula valid
for doubling, the identity and inverses, so the ladder needs no special
cases for the identity it starts from, padded lanes or P + P. Points
are (X:Y:Z) in Montgomery form, each coordinate a (24, ...batch) limb
tensor of ops/field.py. It serves BLS12-381 G1 (a = 0). The ECDSA
kernel's plain version (secp256k1, a = 0; P-256, a = -3) takes the
Jacobian formulas and window ladders below, csrc/ecdsa.cu's own.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from tpubft_torch.ops.field import Field, NL


class WPoint(NamedTuple):
    """Projective (X:Y:Z), Montgomery-form limbs, shape (24, ...batch)."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class Curve:
    def __init__(self, field: Field, a: int, b: int):
        # no generator or order here (the reference's weierstrass.py:37
        # requires them): the ECDSA ladder takes G's multiples from
        # ops/ecdsa.fixed_base_table
        self.f = field
        self.a = a % field.p
        self.b = b % field.p

    def identity(self, batch: Tuple[int, ...], device) -> WPoint:
        f = self.f
        return WPoint(f.zero(batch, device), f.one(batch, device),
                      f.zero(batch, device))

    def from_affine(self, x_m: torch.Tensor, y_m: torch.Tensor) -> WPoint:
        return WPoint(x_m, y_m, self.f.one(x_m.shape[1:], x_m.device))

    def _const(self, v: int, like: torch.Tensor) -> torch.Tensor:
        c = torch.as_tensor(self.f.from_int(v), device=like.device)
        return c.reshape((NL,) + (1,) * (like.dim() - 1))

    def add(self, p: WPoint, q: WPoint) -> WPoint:
        """Complete projective addition (closed RCB form):

        X3 = (X1Y2+X2Y1)(Y1Y2 - a(X1Z2+X2Z1) - 3b Z1Z2)
             - (Y1Z2+Y2Z1)(a X1X2 + 3b(X1Z2+X2Z1) - a^2 Z1Z2)
        Y3 = (3X1X2 + a Z1Z2)(a X1X2 + 3b(X1Z2+X2Z1) - a^2 Z1Z2)
             + (Y1Y2 + a(X1Z2+X2Z1) + 3b Z1Z2)(Y1Y2 - a(X1Z2+X2Z1) - 3b Z1Z2)
        Z3 = (Y1Z2+Y2Z1)(Y1Y2 + a(X1Z2+X2Z1) + 3b Z1Z2)
             + (X1Y2+X2Y1)(3X1X2 + a Z1Z2)

        The a-terms are computed only for a != 0: on G1 (a = 0) they are
        zero, and the reference multiplies by a zero constant
        (weierstrass.py:78-88)."""
        f = self.f
        b3 = self._const(3 * self.b, p.x)
        xx = f.mul(p.x, q.x)
        yy = f.mul(p.y, q.y)
        zz = f.mul(p.z, q.z)
        # cross terms via (u+v)(s+t) - us - vt
        xy = f.sub(f.sub(f.mul(f.add(p.x, p.y), f.add(q.x, q.y)), xx), yy)
        xz = f.sub(f.sub(f.mul(f.add(p.x, p.z), f.add(q.x, q.z)), xx), zz)
        yz = f.sub(f.sub(f.mul(f.add(p.y, p.z), f.add(q.y, q.z)), yy), zz)
        b3_zz = f.mul(b3, zz)
        b3_xz = f.mul(b3, xz)
        t_minus = f.sub(yy, b3_zz)                 # Y1Y2 - aXZ - 3bZZ
        t_plus = f.add(yy, b3_zz)                  # Y1Y2 + aXZ + 3bZZ
        u = b3_xz                                  # aXX + 3bXZ - a^2ZZ
        v = f.add(f.add(xx, xx), xx)               # 3XX + aZZ
        if self.a:
            a = self._const(self.a, p.x)
            a_xz = f.mul(a, xz)
            a_zz = f.mul(a, zz)
            t_minus = f.sub(t_minus, a_xz)
            t_plus = f.add(t_plus, a_xz)
            u = f.sub(f.add(u, f.mul(a, xx)), f.mul(a, a_zz))
            v = f.add(v, a_zz)
        x3 = f.sub(f.mul(xy, t_minus), f.mul(yz, u))
        y3 = f.add(f.mul(v, u), f.mul(t_plus, t_minus))
        z3 = f.add(f.mul(yz, t_plus), f.mul(xy, v))
        return WPoint(x3, y3, z3)

    def select(self, cond: torch.Tensor, p: WPoint, q: WPoint) -> WPoint:
        f = self.f
        return WPoint(f.select(cond, p.x, q.x), f.select(cond, p.y, q.y),
                      f.select(cond, p.z, q.z))

    def scalar_mul_bits(self, bits: torch.Tensor, p: WPoint) -> WPoint:
        """[k]P for a bit matrix (nbits, ...batch), msb-first, from the
        identity: double, then add P where the bit is set. Rows above
        every lane's top set bit leave the identity as it is, so the
        ladder starts at the first row with a set bit (the same points)."""
        acc = self.identity(p.x.shape[1:], p.x.device)
        live = bits.reshape(bits.shape[0], -1).any(1).nonzero()
        if live.numel() == 0:
            return acc
        for row in bits[int(live[0, 0]):]:
            acc = self.add(acc, acc)
            acc = self.select(row.bool(), self.add(acc, p), acc)
        return acc

    # ---- Jacobian (X : Y : Z), x = X / Z^2: csrc/ecdsa.cu's formulas ----
    # The same polynomials as the kernel's (the field is exact, so equal
    # polynomials give equal coordinates), with its exceptional cases as
    # selects: the plain ECDSA ladder's projective result is the kernel's
    # to the word.

    def jac_double(self, p: WPoint) -> WPoint:
        """2P: S = 4 X Y^2, M = 3 X^2 + a Z^4, X3 = M^2 - 2S, Y3 = M (S -
        X3) - 8 Y^4, Z3 = 2 Y Z (Z = 0 stays 0)."""
        f = self.f
        yy = f.mul(p.y, p.y)
        s = f.mul(p.x, yy)
        s = f.add(s, s)
        s = f.add(s, s)
        xx = f.mul(p.x, p.x)
        m = f.add(f.add(xx, xx), xx)
        if self.a:
            zz = f.mul(p.z, p.z)
            m = f.add(m, f.mul(self._const(self.a, p.x), f.mul(zz, zz)))
        x3 = f.sub(f.mul(m, m), f.add(s, s))
        y8 = f.mul(yy, yy)
        for _ in range(3):
            y8 = f.add(y8, y8)
        y3 = f.sub(f.mul(m, f.sub(s, x3)), y8)
        z3 = f.mul(p.y, p.z)
        return WPoint(x3, y3, f.add(z3, z3))

    def jac_add(self, p: WPoint, q: WPoint) -> WPoint:
        """P + Q: U1 = X1 Z2^2, U2 = X2 Z1^2, S1 = Y1 Z2^3, S2 = Y2 Z1^3,
        H = U2 - U1, R = S2 - S1, X3 = R^2 - H^3 - 2 U1 H^2, Y3 = R (U1 H^2
        - X3) - S1 H^3, Z3 = Z1 Z2 H; P = O gives Q, Q = O gives P, H = R
        = 0 (P = Q) the doubling; P = -Q leaves Z3 = 0."""
        f = self.f
        z1z1, z2z2 = f.mul(p.z, p.z), f.mul(q.z, q.z)
        u1, u2 = f.mul(p.x, z2z2), f.mul(q.x, z1z1)
        s1 = f.mul(f.mul(p.y, q.z), z2z2)
        s2 = f.mul(f.mul(q.y, p.z), z1z1)
        h, r = f.sub(u2, u1), f.sub(s2, s1)
        hh = f.mul(h, h)
        hhh = f.mul(h, hh)
        v = f.mul(u1, hh)
        x3 = f.sub(f.sub(f.mul(r, r), hhh), f.add(v, v))
        y3 = f.sub(f.mul(r, f.sub(v, x3)), f.mul(s1, hhh))
        out = WPoint(x3, y3, f.mul(f.mul(p.z, q.z), h))
        out = self.select(f.is_zero(h) & f.is_zero(r), self.jac_double(p),
                          out)
        out = self.select(f.is_zero(q.z), p, out)
        return self.select(f.is_zero(p.z), q, out)

    def _pick(self, table: WPoint, idx: torch.Tensor) -> WPoint:
        """Per lane b, entry idx[b] of a table whose coordinates are
        (entries, 24, B)."""
        i = idx.reshape(1, 1, -1).expand(1, table.x.shape[1], -1)
        return WPoint(*(c.gather(0, i)[0] for c in table))

    def fixed_base_sum(self, tx: torch.Tensor, ty: torch.Tensor,
                       digits: torch.Tensor) -> WPoint:
        """csrc/ecdsa.cu's g_part: sum_j +-T[j][|d_j|] from the identity,
        j upwards, one addition of an affine entry a nonzero digit.
        tx, ty: (windows, entries, 24) limbs of the entries d = 1..;
        digits: (windows, B) signed ints."""
        f = self.f
        batch, dev = (digits.shape[1],), digits.device
        one = f.one(batch, dev)
        acc = self.identity(batch, dev)
        for j in range(digits.shape[0]):
            d = digits[j]
            i = (d.abs() - 1).clamp(min=0)
            x, y = tx[j][i].T, ty[j][i].T
            y = f.select(d < 0, f.neg(y), y)
            acc = self.select(d != 0, self.jac_add(acc, WPoint(x, y, one)),
                              acc)
        return acc

    def window_sum(self, q: WPoint, digits, negs, width: int,
                   beta: Optional[int] = None) -> WPoint:
        """csrc/ecdsa.cu's q_part: the table 1Q .. 2^(width-1) Q (an even
        entry doubles its half, an odd one adds Q), then from the top
        window down `width` doublings (none before the first) and, for
        each scalar c (digits[c]: (windows, B) signed ints, least
        significant first; negs[c]: (B,) bool, the scalar's sign), the
        addition of +-T[|d|] where d != 0; scalar 1 on the endomorphism
        image (beta X : Y : Z) where beta is given."""
        f = self.f
        tab = [None, q]
        for m in range(2, (1 << (width - 1)) + 1):
            tab.append(self.jac_double(tab[m // 2]) if m % 2 == 0
                       else self.jac_add(tab[m - 1], q))
        table = WPoint(*(torch.stack([t[k] for t in tab[1:]])
                         for k in range(3)))
        acc = self.identity(q.x.shape[1:], q.x.device)
        windows = digits[0].shape[0]
        for j in range(windows - 1, -1, -1):
            if j < windows - 1:
                for _ in range(width):
                    acc = self.jac_double(acc)
            for c, (dig, neg) in enumerate(zip(digits, negs)):
                d = dig[j]
                e = self._pick(table, (d.abs() - 1).clamp(min=0))
                x = f.mul(e.x, self._const(beta, e.x)) if c == 1 else e.x
                y = f.select((d < 0) ^ neg, f.neg(e.y), e.y)
                acc = self.select(d != 0, self.jac_add(acc, WPoint(x, y, e.z)),
                                  acc)
        return acc

    def to_affine(self, p: WPoint
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x, y, is_identity): canonical integers (tight limbs, not
        Montgomery) by a Fermat inversion of Z; the identity maps to
        (0, 0, True) (reference weierstrass.py:140)."""
        f = self.f
        zi = f.inv(p.z)
        return (f.from_mont(f.mul(p.x, zi)), f.from_mont(f.mul(p.y, zi)),
                f.is_zero(p.z))

    def msm_reduce(self, p: WPoint) -> WPoint:
        """Tree-reduce along the last axis to one point (..., 1), padding
        the axis with the identity to a power of two: log2(B) batched
        adds."""
        n = p.x.shape[-1]
        width = 1
        while width < n:
            width *= 2
        if width > n:
            pad = self.identity(p.x.shape[1:-1] + (width - n,), p.x.device)
            p = WPoint(*(torch.cat([c, e], -1) for c, e in zip(p, pad)))
        while p.x.shape[-1] > 1:
            h = p.x.shape[-1] // 2
            p = self.add(WPoint(*(c[..., :h] for c in p)),
                         WPoint(*(c[..., h:] for c in p)))
        return p
