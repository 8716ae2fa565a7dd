"""Shared numeric guards for the f64-numpy / f32-torch cutoff twins.

A copy of ``repro.core.cutoff.eps``, same names and values.  Every clip
and epsilon the paired backend implementations
(``order_stats.throughput_curve`` / ``throughput_curve_torch``,
``censoring.truncated_normal_sample`` / ``truncated_normal_sample_torch``,
...) apply lives HERE, once, backend-neutral — so the two distributions
can never drift apart through an edit to one twin.  Route any new guard
through this module rather than typing it inline in a twin.

Values are load-bearing for seeded-parity suites: do not retune without
re-running the controller equivalence tests.
"""

#: floor under a sorted runtime before it divides a throughput count —
#: keeps Omega(c) = c / x_(c) finite at a (degenerate) zero runtime.
OMEGA_FLOOR = 1e-9

#: floor under a predictive std before truncated-normal sampling; a
#: collapsed (zero-variance) predictive still inverts cleanly.
SIGMA_FLOOR = 1e-9

#: keep the truncation CDF strictly below 1 so the inverse-CDF stays
#: finite in f32 — tighter clips (1e-9/1e-12) round to exactly 1.0f and
#: the f32 twin would emit inf where the f64 reference does not.
CDF_CLIP = 1e-6

#: floor on the imputation uniform before inverse-CDF (u=0 maps to
#: -inf); asymmetric with CDF_CLIP on purpose — the low tail is safe in
#: f32 down to 1e-7.
U_CLIP_LO = 1e-7
