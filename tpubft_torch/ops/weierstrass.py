"""Short-Weierstrass curve ops (y^2 = x^3 + ax + b) over a torch Field: the
plain PyTorch counterpart of tpubft/ops/weierstrass.py::Curve, written
for the port.

The complete projective addition law (Renes-Costello-Batina closed form,
the reference's weierstrass.py:58-99): one branch-free formula valid
for doubling, the identity and inverses, so the ladder needs no special
cases for the identity it starts from, padded lanes or P + P. Points
are (X:Y:Z) in Montgomery form, each coordinate a (24, ...batch) limb
tensor of ops/field.py. It serves BLS12-381 G1 (a = 0), secp256k1
(a = 0) and P-256 (a = -3, the first user of the a-terms).
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
    def __init__(self, field: Field, a: int, b: int,
                 gx: Optional[int] = None, gy: Optional[int] = None,
                 order: Optional[int] = None):
        # the generator and order are optional here (the reference's
        # weierstrass.py:37 requires them): the BLS callers build
        # Curve(field, a, b)
        self.f = field
        self.a = a % field.p
        self.b = b % field.p
        self.gx, self.gy, self.order = gx, gy, order

    def identity(self, batch: Tuple[int, ...], device) -> WPoint:
        f = self.f
        return WPoint(f.zero(batch, device), f.one(batch, device),
                      f.zero(batch, device))

    def generator(self, batch: Tuple[int, ...], device) -> WPoint:
        f = self.f
        return WPoint(*(torch.as_tensor(f.from_int(v), device=device)
                        .reshape((NL,) + (1,) * len(batch))
                        .expand((NL,) + tuple(batch)).clone()
                        for v in (self.gx, self.gy)),
                      f.one(batch, device))

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

    def shamir_bits(self, bits1: torch.Tensor, p1: WPoint,
                    bits2: torch.Tensor, p2: WPoint) -> WPoint:
        """[k1]P1 + [k2]P2 as csrc/ecdsa.cu's ladder runs it, for its plain
        version (ops/ecdsa.py): P1 + P2 is added once up front, then each
        step doubles (the complete addition of acc to itself) and adds
        P1, P2 or P1 + P2 where the step's digit b1 + 2 b2 is not 0. The
        projective result is the kernel's to the word; the point equals
        the reference's double_scalar_mul_bits' (weierstrass.py:118)."""
        acc = self.identity(p1.x.shape[1:], p1.x.device)
        both = (bits1 | bits2).reshape(bits1.shape[0], -1).any(1).nonzero()
        if both.numel() == 0:
            return acc
        p12 = self.add(p1, p2)
        for b1, b2 in zip(bits1[int(both[0, 0]):], bits2[int(both[0, 0]):]):
            acc = self.add(acc, acc)
            b1, b2 = b1.bool(), b2.bool()
            t = self.select(b1 & b2, p12, self.select(b1, p1, p2))
            acc = self.select(b1 | b2, self.add(acc, t), acc)
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
