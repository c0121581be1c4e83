/* Weighted concordance-index kernel.
 *
 * O(n^2) pair scan with O(1) memory — the numpy implementation in
 * evaluation/survival_metrics.py materializes n x n boolean matrices, which
 * is fine for TCGA-sized cohorts (hundreds) but not for biobank-scale ones
 * (n ~ 1e5 would need ~10 GB per matrix).  Semantics are identical:
 *
 *   comparable (i, j): event_i && (t_i < t_j || (t_i == t_j && !event_j))
 *   concordant: estimate_i > estimate_j (ties within tied_tol count 0.5)
 *   weights: per-i multiplier (1 for Harrell, IPCW^2 for Uno)
 *
 * Built on demand by imp_torch.native (cc -O3 -shared), loaded via ctypes.
 */

#include <math.h>
#include <stddef.h>

typedef struct {
    double numerator;
    double denominator;
    long long concordant;
    long long discordant;
    long long tied_risk;
    long long tied_time;
} cindex_result;

void weighted_concordance(const unsigned char *event,
                          const double *time_arr,
                          const double *estimate,
                          const double *weights,
                          long long n,
                          double tied_tol,
                          cindex_result *out) {
    double numerator = 0.0, denominator = 0.0;
    long long concordant = 0, discordant = 0, tied_risk = 0, tied_time = 0;

    for (long long i = 0; i < n; ++i) {
        if (!event[i]) continue;
        const double ti = time_arr[i];
        const double ei = estimate[i];
        const double wi = weights[i];
        for (long long j = 0; j < n; ++j) {
            const double tj = time_arr[j];
            int comparable = (ti < tj) || (ti == tj && !event[j] && i != j);
            if (!comparable) continue;
            const double diff = ei - estimate[j];
            denominator += wi;
            if (fabs(diff) <= tied_tol) {
                numerator += 0.5 * wi;
                tied_risk += 1;
            } else if (diff > 0.0) {
                numerator += wi;
                concordant += 1;
            } else {
                discordant += 1;
            }
            if (ti == tj) tied_time += 1;
        }
    }
    out->numerator = numerator;
    out->denominator = denominator;
    out->concordant = concordant;
    out->discordant = discordant;
    out->tied_risk = tied_risk;
    out->tied_time = tied_time;
}
