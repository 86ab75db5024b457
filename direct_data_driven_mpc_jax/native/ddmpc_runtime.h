/* ddmpc_runtime.h -- standalone C99 deployment runtime for direct
 * data-driven MPC controllers designed with direct_data_driven_mpc_jax.
 *
 * The Python/JAX framework does the expensive design-time work (Hankel
 * construction, persistent-excitation validation, KKT factorization /
 * ADMM pre-factorization); `utils/export.py` serializes the resulting
 * condensed per-step operator to a blob this runtime loads. At run
 * time each control step is:
 *
 *     ddmpc_solve(c);                        // microseconds
 *     apply c->u_opt[0..m-1] to the plant;
 *     ddmpc_observe(c, u_applied, y_measured);
 *
 * following the paper's Algorithm 1 (n_mpc_step == 1) or Algorithm 2
 * (solve every n_mpc_step steps, applying u_opt rows 0..n_mpc_step-1).
 * No dynamic allocation after load; no dependencies beyond libc/libm.
 *
 * Semantics match the Python controller exactly
 * (control/controller.py; reference behavior:
 * /root/reference/direct_data_driven_mpc/
 * direct_data_driven_mpc_controller.py:389-407, 844-943).
 */
#ifndef DDMPC_RUNTIME_H
#define DDMPC_RUNTIME_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
    /* dimensions */
    int kind;       /* 0 = affine (slack NONE), 1 = ADMM (slack CONVEX) */
    int n, m, p, L; /* system order, inputs, outputs, horizon */
    int n_mpc_step; /* input-application cadence (Algorithm 1 vs 2) */
    int ns;         /* embedded plant state dim (0 = none) */
    int nbox;       /* ADMM box dim (L*p), 0 for affine */
    int admm_iters; /* ADMM max iterations per solve */
    int nt;         /* theta dim = n*(m+p) */
    int nu;         /* solution dim = L*m */

    /* scalars */
    double cost_r, bound, rho, alpha, tol, eps_max;

    /* measurement window (theta = [u_past; y_past], most recent last) */
    double *u_past; /* (n*m) */
    double *y_past; /* (n*p) */

    /* operator (kind 0) */
    double *u_base, *U_gain, *cost_P, *cost_q;

    /* operator (kind 1); cost_P/cost_q above are over [theta; s-w] */
    double *v_c, *V_theta, *V_s, *u_c, *U_theta, *U_s;
    double *s, *w; /* warm-started ADMM state, persists across solves */

    /* embedded plant (ns > 0): y = Cx + Du + w, then x <- Ax + Bu */
    double *A, *B, *C, *D, *x;

    /* last solve results */
    double *u_opt; /* (L*m) optimal input sequence ubar*[0..L-1] */
    double cost;
    double r_prim, r_dual; /* ADMM exit residuals (kind 1) */
    int iters;             /* ADMM iterations used (kind 1) */
    int converged;         /* 1 if exact (kind 0) or within tol */

    /* internal scratch */
    double *theta, *scr, *scr2;
} ddmpc_controller;

/* Load a controller blob written by utils/export.py::export_controller.
 * Returns NULL on I/O or format error (message on stderr). */
ddmpc_controller *ddmpc_load(const char *path);

void ddmpc_free(ddmpc_controller *c);

/* Solve the MPC QP at the current measurement window. Fills u_opt,
 * cost, converged (and iters/r_prim/r_dual for kind 1). Returns 0 on
 * success. */
int ddmpc_solve(ddmpc_controller *c);

/* Row k (0 <= k < L) of the optimal input sequence: u_opt + k*m. */
const double *ddmpc_input_at_step(const ddmpc_controller *c, int k);

/* Shift the measurement window: append (u applied, y measured),
 * dropping the oldest sample (ring-buffer semantics of
 * store_input_output_measurement). u: (m), y: (p). */
void ddmpc_observe(ddmpc_controller *c, const double *u, const double *y);

/* Step the embedded plant (ns > 0 only): writes y (p) for input u (m)
 * and measurement noise w (p), then advances the internal state.
 * Returns 0 on success, -1 if no plant block was exported. */
int ddmpc_plant_step(ddmpc_controller *c, const double *u,
                     const double *w, double *y);

#ifdef __cplusplus
}
#endif

#endif /* DDMPC_RUNTIME_H */
