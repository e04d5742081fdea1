"""Dual coordinate-descent QP with an example cache.

Host-side counterpart of the reference's QP machinery
(reference: matlab/learning/qp_write.m, qp_one.m, qp_opt.m, qp_prune.m,
matlab/oct/qp_one_sparse.cc):

  min_{v,e}  0.5 ||v||^2 + sum_i e_i
  s.t.       v . x'_ij >= b'_ij - e_i,   e_i >= 0

after the standardizing substitution v = (w - w0) * r,
x' = C * (+-feat) / r, b' = C * (1 - w0 . (+-feat))
(reference: matlab/learning/qp_write.m:7-16).  Groups of constraints
sharing an id share one slack: the dual box constraint is
sum_{j in id} alpha_j <= 1 with the group budget C = 1 after scaling.

Storage is dense float32 (the reference's block-sparse encoding exists
to fit Matlab memory limits; dense rows keep the numpy coordinate
descent simple and vectorizable)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


class QPCache:
    def __init__(self, length: int, nmax: int,
                 wreg: np.ndarray, w0: np.ndarray,
                 noneg: np.ndarray,
                 c_pos: float, c_neg: float, seed: int = 0):
        self.len = length
        self.nmax = nmax
        self.wreg = wreg.astype(np.float64)
        self.w0 = w0.astype(np.float64)
        self.noneg = noneg
        self.c_pos = float(c_pos)
        self.c_neg = float(c_neg)
        self.x = np.zeros((nmax, length), np.float32)
        self.ids = np.zeros((nmax, 5), np.int64)
        self.b = np.zeros(nmax, np.float64)
        self.d = np.zeros(nmax, np.float64)
        self.a = np.zeros(nmax, np.float64)
        self.sv = np.zeros(nmax, bool)
        self.n = 0
        self.svfix = 0            # first svfix examples are permanent
        self.w = np.zeros(length)
        self.lb = 0.0
        self.ub = np.inf
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------- write
    def write(self, feat: np.ndarray, ex_id, label: int) -> bool:
        """Add one example (reference: qp_write.m).  feat: dense raw
        feature vector (unscaled); ex_id: 5-tuple (label, image, level,
        y, x); label: +1 / -1.  Returns False when the cache is full."""
        if self.n >= self.nmax:
            return False
        C = self.c_pos if label > 0 else self.c_neg
        s = feat if label > 0 else -feat
        x = C * s / self.wreg
        i = self.n
        self.x[i] = x
        self.b[i] = C * (1.0 - self.w0 @ s)
        self.d[i] = float(x @ x)
        self.ids[i] = np.asarray(ex_id, np.int64)
        self.a[i] = 0.0
        self.sv[i] = True
        self.n += 1
        return True

    # ----------------------------------------------------------- solver
    def _group_keys(self) -> np.ndarray:
        """Group index per example (same id tuple -> same group)."""
        _, inv = np.unique(self.ids[:self.n], axis=0,
                           return_inverse=True)
        return inv

    def refresh(self):
        """Recompute w from the dual variables
        (reference: qp_refresh.m)."""
        I = np.nonzero(self.a[:self.n] > 0)[0]
        self.w = (self.a[:self.n][I, None]
                  * self.x[:self.n][I].astype(np.float64)).sum(0)
        self._project_noneg()
        self.lb = float(self.a[:self.n] @ self.b[:self.n]
                        - 0.5 * self.w @ self.w)

    def _project_noneg(self):
        """Clamp non-negative coordinates: v >= 0 for def quadratic
        terms (v = (w - w0) * r with w >= w0 -> v >= 0; reference:
        qp_one_sparse.cc applies the same clamp during descent)."""
        if len(self.noneg):
            self.w[self.noneg] = np.maximum(self.w[self.noneg], 0.0)

    def one_pass(self):
        """One randomized coordinate-descent pass over the support set
        (reference: qp_one.m / qp_one_sparse.cc).  Tracks a running
        upper-bound estimate from the worst violation per group, like
        qp_one_sparse's loss accumulator."""
        groups = self._group_keys()
        ngroups = groups.max() + 1 if self.n else 1
        gsum = np.zeros(ngroups)
        for i in range(self.n):
            gsum[groups[i]] += self.a[i]
        I = np.nonzero(self.sv[:self.n])[0]
        self.rng.shuffle(I)
        C = 1.0
        gerr = np.zeros(ngroups)
        for i in I:
            g = groups[i]
            xi = self.x[i].astype(np.float64)
            G = self.w @ xi - self.b[i]
            gerr[g] = max(gerr[g], -G)
            ai = self.a[i]
            if ai == 0.0 and G >= 0.0:
                self.sv[i] = i < self.svfix
                continue
            # clamp step to [0, ai + remaining group budget]
            if self.d[i] <= 0:
                continue
            anew = np.clip(ai - G / self.d[i], 0.0,
                           ai + (C - gsum[g]))
            if anew != ai:
                self.w += (anew - ai) * xi
                self._project_noneg()
                gsum[g] += anew - ai
                self.a[i] = anew
            self.sv[i] = (self.a[i] > 0) or (i < self.svfix)
        self.lb = float(self.a[:self.n] @ self.b[:self.n]
                        - 0.5 * self.w @ self.w)
        self.ub = min(self.ub,
                      0.5 * float(self.w @ self.w)
                      + C * float(np.maximum(gerr, 0.0).sum()))

    def _true_ub(self) -> float:
        """Primal objective with grouped hinge loss
        (reference: qp_opt.m computeloss)."""
        slack = self.b[:self.n] - self.x[:self.n].astype(np.float64) \
            @ self.w
        groups = self._group_keys()
        loss = 0.0
        for g in range(groups.max() + 1 if self.n else 0):
            m = slack[groups == g].max(initial=0.0)
            loss += max(m, 0.0)
        return 0.5 * float(self.w @ self.w) + loss

    def optimize(self, tol: float = 0.05, max_iter: int = 1000):
        """Iterate CD passes until the relative duality gap < tol
        (reference: qp_opt.m)."""
        self.refresh()
        self.sv[:self.n] = True
        self.ub = np.inf
        ub = self._true_ub()
        for _ in range(max_iter):
            self.one_pass()
            if self.lb > 0 and 1.0 - self.lb / min(self.ub, ub) < tol:
                ub = min(ub, self._true_ub())
                if 1.0 - self.lb / ub < tol:
                    break
                self.sv[:self.n] = True
        self.ub = ub

    def prune(self):
        """Drop non-support examples beyond the fixed prefix
        (reference: qp_prune.m)."""
        keep = self.sv[:self.n] | (self.a[:self.n] > 0)
        keep[:self.svfix] = True
        idx = np.nonzero(keep)[0]
        m = len(idx)
        for arr in (self.x, self.ids):
            arr[:m] = arr[idx]
        for arr in (self.b, self.d, self.a):
            arr[:m] = arr[idx]
        self.sv[:m] = self.sv[idx]
        self.sv[m:self.n] = False
        self.n = m

    # ----------------------------------------------------------- scores
    def final_w(self) -> np.ndarray:
        """Solution in original model coordinates:
        w = v / r + w0 (reference: qp_w.m inverse substitution)."""
        return self.w / self.wreg + self.w0

    def score_positives(self) -> np.ndarray:
        """Raw scores of cached positive examples
        (reference: train.m qp_scorepos)."""
        pos = self.ids[:self.n, 0] > 0
        if not pos.any():
            return np.zeros(0)
        wfull = self.w + self.w0 * self.wreg
        return (self.x[:self.n][pos].astype(np.float64) @ wfull) \
            / self.c_pos
