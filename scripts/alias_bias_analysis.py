"""Determine whether the exact-coin alias path has residual bias.
A deterministic analysis that runs on the CPU.

Two questions, answered deterministically where possible:

1. TABLE exactness: the alias table implies a landing distribution
       P(i) = (1/n) * (prob_i + sum_{j: alias_j == i} (1 - prob_j))
   computable in float64 directly from the packed rows.  If the
   construction is exact, P(i) == pmf_i / total up to f32 packing of the
   per-row thresholds.  Any systematic builder bias shows up here with
   ZERO Monte-Carlo noise.

2. ESTIMATOR power: the failing test's inverse-pdf estimator
   E[1[idx in S]/pdf(idx)] has an exactly computable per-sample variance
       Var = sum_{i in S} 1/q_i - |S|^2     (q_i = pmf_i/total)
   so we can state the gate's sigma level precisely.
"""
import numpy as np
import jax.numpy as jnp

import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
jax.config.update("jax_platforms", "cpu")

from psdr_jax.core.distribution import DiscreteDistribution
from psdr_jax.core.sampler import Sampler

n = 1 << 17
rng = np.random.default_rng(1)
pmf = jnp.asarray((rng.uniform(0.02, 1.0, n) ** 2).astype(np.float32))
d = DiscreteDistribution.init(pmf).with_alias()

rows = np.asarray(d.alias_rows, np.float64)
prob, alias = rows[:, 0], rows[:, 1].astype(np.int64)

# implied landing distribution, float64
P = prob.copy()
np.add.at(P, alias, 1.0 - prob)
P /= n

p64 = np.asarray(pmf, np.float64)
total64 = p64.sum()
q = p64 / total64

rel = (P - q) / q
print("TABLE implied-landing vs pmf/total:")
print(f"  max |rel| = {np.abs(rel).max():.3e}")
print(f"  mean rel  = {rel.mean():.3e}")
print(f"  sum P     = {P.sum():.12f} (should be 1)")

# pdf returned by sample path: rows[:,2]/total_f32  vs  q
total32 = float(np.asarray(d.total, np.float64))
pdf_ret = rows[:, 2] / total32
rel_pdf = (pdf_ret - q) / q
print("returned pdf vs exact q:")
print(f"  max |rel| = {np.abs(rel_pdf).max():.3e}  mean = {rel_pdf.mean():.3e}")
print(f"  total32/total64 - 1 = {total32/total64 - 1:.3e}")

# estimator bias implied by table alone (no MC): E[est] = sum_{i in S} P_i/pdf_i
for lo, hi in ((0, n // 3), (n // 3, n)):
    sel = slice(lo, hi)
    implied = (P[sel] / pdf_ret[sel]).sum()
    expect = hi - lo
    # exact per-sample std of the MC estimator
    var = (P[sel] / pdf_ret[sel] ** 2).sum() - implied**2
    m = 1 << 21
    se_rel = np.sqrt(var / m) / expect
    print(f"  S=[{lo},{hi}): implied bias = {implied/expect - 1:+.3e}, "
          f"MC SE(m=2^21) rel = {se_rel:.3e} -> 5e-3 gate = "
          f"{5e-3/se_rel:.2f} sigma")

# now one MC run with float64 accumulation to confirm
m = 1 << 21
s = Sampler(7, jnp.arange(m, dtype=jnp.uint32))
u = s.next_1d()
coin = s.next_1d()
idx, p, u2 = d.sample_reuse(u, coin)
idx = np.asarray(idx)
pdf = np.asarray(p, np.float64)
for lo, hi in ((0, n // 3), (n // 3, n)):
    sel = (idx >= lo) & (idx < hi)
    est = np.where(sel, 1.0 / np.maximum(pdf, 1e-300), 0.0).mean()
    est32 = np.where(sel, (1.0 / np.maximum(pdf, 1e-30)).astype(np.float32),
                     0.0).astype(np.float32).mean()
    expect = hi - lo
    print(f"  MC S=[{lo},{hi}): f64 est rel err = {est/expect-1:+.4e}, "
          f"f32-ish = {est32/expect-1:+.4e}")

# also: landing-count chi-square (full pipeline check, float64)
counts = np.bincount(idx, minlength=n).astype(np.float64)
exp_counts = m * P
chi2 = ((counts - exp_counts) ** 2 / exp_counts).sum()
z = (chi2 - (n - 1)) / np.sqrt(2.0 * (n - 1))
print(f"chi-square vs IMPLIED table distribution: chi2={chi2:.1f}, "
      f"df={n-1}, z={z:+.2f}")
exp_q = m * q
chi2q = ((counts - exp_q) ** 2 / exp_q).sum()
zq = (chi2q - (n - 1)) / np.sqrt(2.0 * (n - 1))
print(f"chi-square vs pmf/total:                  chi2={chi2q:.1f}, z={zq:+.2f}")
