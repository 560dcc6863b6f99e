"""The erasure codes, from their published constructions.

Reed-Solomon (`rs_matrix`): Plank's Vandermonde construction with the
2005 correction, V[i][j] = i**j over the k+m rows i = 0 .. k+m-1,
brought to systematic form [I; C] by column operations. Any sequence of
column operations that turns the top k x k block into I right-multiplies
V by that block's inverse, so C = V_bottom @ inverse(V_top).

Clay (`Clay`): Vajha et al., "Clay Codes: Moulding MDS Codes to Yield
an MSR Code", USENIX FAST 2018. q = d-k+1, t = ceil((k+m)/q), nu =
q*t-(k+m) zero nodes after the data nodes, q**t planes (sub-chunks of
a chunk, plane z at bytes [z*s, (z+1)*s)). Node n sits at (x, y) = (n
mod q, n div q). In plane z, node (x, y) with digit y of z (z_y) equal
to x is unpaired and its coupled symbol C equals the uncoupled U;
otherwise it pairs with node (z_y, y) in plane z' (z with digit y set
to x) by C = U + g*U', C' = g*U + U' (g = gamma = 2), so U = (C +
g*C') / (1 + g*g). In every plane the uncoupled symbols form a
codeword of the systematic MDS base code over the q*t nodes (the RS
code above, k+nu data and m parity nodes). Everything is linear, so the
code is a generator matrix over sub-chunks, solved here once.
"""

from __future__ import annotations

import numpy as np

from . import gf


def rs_matrix(k: int, m: int) -> np.ndarray:
    """The (m, k) systematic coding matrix C."""
    V = np.array([[gf.power(i, j) for j in range(k)] for i in range(k + m)],
                 np.uint8)
    # C @ V_top = V_bottom  <=>  V_top^T @ C^T = V_bottom^T
    return gf.solve(V[:k].T, V[k:].T).T.copy()


def rs_generator(k: int, m: int) -> np.ndarray:
    """(k+m, k): the identity over the coding matrix."""
    return np.concatenate([np.eye(k, dtype=np.uint8), rs_matrix(k, m)])


def decode_matrix(G: np.ndarray, rows_in: list, rows_out: list
                  ) -> np.ndarray:
    """D with D @ G[rows_in] == G[rows_out]: the outputs from the inputs
    (raises where the inputs do not determine them)."""
    A, Bm = G[list(rows_in)], G[list(rows_out)]
    return gf.solve(A.T, Bm.T).T.copy()


class Clay:
    """The Clay code's generator and repair matrices (rows and columns
    are chunk-major, plane-minor)."""

    def __init__(self, k: int, m: int, d: int, gamma: int = 2):
        if not k + 1 <= d <= k + m - 1:
            raise ValueError(f"clay d={d} outside [k+1, k+m-1]")
        self.k, self.m, self.d, self.gamma = k, m, d, gamma
        self.q = d - k + 1
        self.t = -(-(k + m) // self.q)
        self.nu = self.q * self.t - (k + m)
        self.planes = self.q ** self.t
        self.base = rs_matrix(k + self.nu, m)
        self._gen = None

    def node(self, chunk: int) -> int:
        return chunk if chunk < self.k else chunk + self.nu

    def digit(self, z: int, y: int) -> int:
        return (z // self.q ** y) % self.q

    def repair_planes(self, chunk: int) -> list[int]:
        """The planes in which the chunk's node is unpaired: the ones
        its helpers ship."""
        n = self.node(chunk)
        x, y = n % self.q, n // self.q
        return [z for z in range(self.planes) if self.digit(z, y) == x]

    def _uncouple(self) -> np.ndarray:
        """T with U = T @ C over all (node, plane) symbols."""
        q, P, g = self.q, self.planes, self.gamma
        nn = q * self.t
        c = gf.inv(1 ^ gf.mul(g, g))
        T = np.zeros((nn * P, nn * P), np.uint8)
        for n in range(nn):
            x, y = n % q, n // q
            for z in range(P):
                zy = self.digit(z, y)
                if zy == x:
                    T[n * P + z, n * P + z] = 1
                    continue
                p = y * q + zy
                zp = z + (x - zy) * q ** y
                T[n * P + z, n * P + z] = c
                T[n * P + z, p * P + zp] = gf.mul(g, c)
        return T

    def generator(self) -> np.ndarray:
        """((k+m) P, k P): every chunk's sub-chunks from the data's."""
        if self._gen is not None:
            return self._gen
        k, m, P = self.k, self.m, self.planes
        nn = self.q * self.t
        H = np.concatenate([self.base, np.eye(m, dtype=np.uint8)], axis=1)
        # parity checks plane by plane: sum_n H[r, n] U(n, z) = 0
        Hbig = np.zeros((m * P, nn * P), np.uint8)
        for r in range(m):
            for n in range(nn):
                for z in range(P):
                    Hbig[r * P + z, n * P + z] = H[r, n]
        Q = gf.matmul(Hbig, self._uncouple())
        data_cols = np.arange(k * P)
        par_cols = np.arange((k + self.nu) * P, nn * P)
        # Q_par @ C_par = Q_data @ C_data (characteristic 2)
        E = gf.solve(Q[:, par_cols], Q[:, data_cols])
        self._gen = np.concatenate([np.eye(k * P, dtype=np.uint8), E])
        return self._gen

    def encode_matrix(self) -> np.ndarray:
        """(m P, k P): the parity chunks' sub-chunks from the data's."""
        return self.generator()[self.k * self.planes:]

    def shipped_rows(self, helpers: list, planes: list) -> list[int]:
        """Generator rows of the helpers' shipped sub-chunks, helper-
        major and plane-minor."""
        return [h * self.planes + z for h in helpers for z in planes]

    def repair_matrix(self, chunk: int, helpers: list) -> np.ndarray:
        """(P, d * beta): the chunk's sub-chunks from its helpers'
        repair-plane sub-chunks."""
        P = self.planes
        return decode_matrix(self.generator(),
                             self.shipped_rows(helpers,
                                               self.repair_planes(chunk)),
                             [chunk * P + z for z in range(P)])
