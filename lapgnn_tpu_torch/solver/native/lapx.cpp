// lapx: dense Jonker-Volgenant assignment solver with warm-start support.
//
// The port's copy of the dense, warm-started and sparse solvers and the dual
// repair of lapgnn_tpu/solver/native/lapx.cpp: the exact float64 host solve
// of the hybrid path, the certify-and-polish pass of the device path and the
// LAPMOD front end, written around a small DualState struct and a
// plain-Dijkstra augmenting search.
//
// Exposed via extern "C" for ctypes:
//   lapx_dense(n, C, x, y, u, v)                     - cold optimal solve
//   lapx_seeded(n, C, u_seed, v_seed, eps, x, y, fb) - warm-started solve
//   lapx_repair_duals(n, C, x, v, max_scans, min_red) - dual repair of a
//                                                       candidate assignment
//   lapx_sparse(n, row_ptr, col_idx, val, x, y, u, v, fp) - CSR (LAPMOD) solve
//
// The solvers return 0 on success and fill x (column of each row), y (row of
// each column) and the final dual potentials. Costs are row-major double.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

namespace {

using std::vector;

constexpr double INF = std::numeric_limits<double>::infinity();

struct DualState {
  int n;
  const double* C;                // row-major n*n
  vector<int> col_of_row;         // x: -1 while unassigned
  vector<int> row_of_col;         // y: -1 while unassigned
  vector<double> v;               // column potentials

  explicit DualState(int n_, const double* C_)
      : n(n_), C(C_), col_of_row(n_, -1), row_of_col(n_, -1), v(n_, 0.0) {}

  double cost(int i, int j) const { return C[(size_t)i * n + j]; }
  double slack(int i, int j) const { return cost(i, j) - v[j]; }
};

// Phase 1: column reduction + reduction transfer. Each column points at its
// cheapest row; rows claimed by several columns keep one claim; uniquely
// claimed rows donate slack back to their column potential. Returns the rows
// still unassigned.
vector<int> column_reduce(DualState& S) {
  const int n = S.n;
  vector<int> claim_count(n, 0);
  vector<int> best_row(n, 0);

  for (int j = 0; j < n; ++j) {
    double best = S.cost(0, j);
    int arg = 0;
    for (int i = 1; i < n; ++i) {
      const double c = S.cost(i, j);
      if (c < best) {
        best = c;
        arg = i;
      }
    }
    S.v[j] = best;
    best_row[j] = arg;
    ++claim_count[arg];
  }

  // Walk columns high-to-low; the first claim a row sees sticks.
  for (int j = n - 1; j >= 0; --j) {
    const int i = best_row[j];
    if (S.col_of_row[i] < 0) {
      S.col_of_row[i] = j;
      S.row_of_col[j] = i;
    }
  }

  // Reduction transfer for rows that exactly one column pointed at.
  for (int i = 0; i < n; ++i) {
    const int j0 = S.col_of_row[i];
    if (j0 >= 0 && claim_count[i] == 1) {
      double second = INF;
      for (int j = 0; j < n; ++j) {
        if (j != j0) second = std::min(second, S.slack(i, j));
      }
      if (second < INF) S.v[j0] -= second;
    }
  }

  vector<int> free_rows;
  for (int i = 0; i < n; ++i)
    if (S.col_of_row[i] < 0) free_rows.push_back(i);
  return free_rows;
}

// Phase 2: one augmenting-row-reduction sweep. Each free row grabs its
// cheapest column, lowering that column's potential by the gap to the second
// cheapest; a displaced row re-enters the queue. Bounded to avoid cycling on
// degenerate (tied) instances.
vector<int> arr_sweep(DualState& S, const vector<int>& free_in) {
  const int n = S.n;
  vector<int> queue = free_in;
  vector<int> still_free;
  size_t head = 0;
  long long budget = (long long)n * (long long)std::max<size_t>(free_in.size(), 1);

  while (head < queue.size()) {
    const int i = queue[head++];
    // Two cheapest slacks in row i.
    double s1 = INF, s2 = INF;
    int j1 = -1, j2 = -1;
    for (int j = 0; j < n; ++j) {
      const double s = S.slack(i, j);
      if (s < s1) {
        s2 = s1;
        j2 = j1;
        s1 = s;
        j1 = j;
      } else if (s < s2) {
        s2 = s;
        j2 = j;
      }
    }
    if (j1 < 0) continue;

    int target = j1;
    const bool lowers = s2 > s1;
    if (--budget >= 0) {
      if (lowers) {
        S.v[j1] -= (s2 - s1);
      } else if (S.row_of_col[j1] >= 0 && j2 >= 0) {
        target = j2;  // tie: avoid displacing if an equal column is open
      }
    }

    const int displaced = S.row_of_col[target];
    if (displaced >= 0) {
      if (budget >= 0 && lowers) {
        queue.push_back(displaced);
      } else {
        still_free.push_back(displaced);
      }
      S.col_of_row[displaced] = -1;
    }
    S.col_of_row[i] = target;
    S.row_of_col[target] = i;
  }
  return still_free;
}

// Phase 3: shortest augmenting path (plain dense Dijkstra over columns) from
// one free row; updates potentials on the settled set and flips the path.
int augment_from(DualState& S, int free_row) {
  const int n = S.n;
  vector<double> d(n);
  vector<int> pred(n, free_row);
  vector<char> settled(n, 0);

  for (int j = 0; j < n; ++j) d[j] = S.slack(free_row, j);

  int sink = -1;
  double sink_dist = 0.0;
  for (int iter = 0; iter <= n; ++iter) {
    // Cheapest unsettled column.
    int jmin = -1;
    double dmin = INF;
    for (int j = 0; j < n; ++j) {
      if (!settled[j] && d[j] < dmin) {
        dmin = d[j];
        jmin = j;
      }
    }
    if (jmin < 0) return -1;  // disconnected: no augmenting path

    const int owner = S.row_of_col[jmin];
    if (owner < 0) {
      sink = jmin;
      sink_dist = dmin;
      break;
    }
    settled[jmin] = 1;
    // Relax every open column through the owner row.
    const double base = dmin - S.slack(owner, jmin);
    for (int j = 0; j < n; ++j) {
      if (settled[j]) continue;
      const double cand = base + S.slack(owner, j);
      if (cand < d[j]) {
        d[j] = cand;
        pred[j] = owner;
      }
    }
  }
  if (sink < 0) return -1;

  // Potential update on settled columns keeps reduced costs non-negative.
  for (int j = 0; j < n; ++j)
    if (settled[j]) S.v[j] += d[j] - sink_dist;

  // Flip the alternating path back to the free row.
  int j = sink;
  for (int guard = 0; guard <= n; ++guard) {
    const int i = pred[j];
    S.row_of_col[j] = i;
    std::swap(S.col_of_row[i], j);
    if (i == free_row) return 0;
  }
  return -1;
}

int augment_all(DualState& S, const vector<int>& free_rows) {
  for (int f : free_rows) {
    if (S.col_of_row[f] >= 0) continue;
    const int rc = augment_from(S, f);
    if (rc != 0) return rc;
  }
  // Final rescan: arr_sweep drops rows with no finite slack from its free
  // list (j1 < 0 -> continue), so the caller-supplied list can be
  // incomplete.  A disconnected row must surface as rc = -1, not as a
  // silent x[i] = -1 inside an rc = 0 "success" (the sparse path rescans
  // the same way).
  for (int i = 0; i < S.n; ++i) {
    if (S.col_of_row[i] < 0) {
      const int rc = augment_from(S, i);
      if (rc != 0) return rc;
    }
  }
  return 0;
}

void export_solution(const DualState& S, int32_t* x, int32_t* y, double* u_out,
                     double* v_out) {
  for (int i = 0; i < S.n; ++i) {
    x[i] = S.col_of_row[i];
    const int j = S.col_of_row[i];
    if (u_out) u_out[i] = (j >= 0) ? S.cost(i, j) - S.v[j] : 0.0;
  }
  for (int j = 0; j < S.n; ++j) {
    y[j] = S.row_of_col[j];
    if (v_out) v_out[j] = S.v[j];
  }
}

int solve_cold(DualState& S) {
  vector<int> free_rows = column_reduce(S);
  for (int pass = 0; pass < 2 && !free_rows.empty(); ++pass)
    free_rows = arr_sweep(S, free_rows);
  return augment_all(S, free_rows);
}

}  // namespace

extern "C" {

int lapx_dense(int n, const double* C, int32_t* x, int32_t* y, double* u_out,
               double* v_out) {
  if (n <= 0 || !C || !x || !y) return -2;
  DualState S(n, C);
  const int rc = solve_cold(S);
  if (rc != 0) return rc;
  export_solution(S, x, y, u_out, v_out);
  return 0;
}

// Warm-started solve mirroring the reference's phase structure
// (lapjv_seeded.cpp:19-173): project the seed to feasibility, tighten rows,
// greedily match tight edges, gate, micro-ARR on leftover free rows, then
// augment.  ``gate`` selects the cold-fallback criterion (mirrors the device
// solver, solver/seeded.py): 0 = tight-edge density < 1.2 n (reference rule,
// lapjv_seeded.cpp:116 — overly conservative for min-trick seeds whose tight
// structure is sparse, e.g. metric-family instances), 1 = more than half the
// rows still free after the greedy phase (a direct measure of remaining
// augmentation work), 2 = never fall back (still exactly optimal).
int lapx_seeded(int n, const double* C, const double* u_seed,
                const double* v_seed, double eps, int32_t* x, int32_t* y,
                int32_t* used_fallback, double* u_out, double* v_out,
                int gate) {
  if (n <= 0 || !C || !x || !y) return -2;
  DualState S(n, C);

  vector<double> u(u_seed, u_seed + n);
  S.v.assign(v_seed, v_seed + n);

  // Feasibility projection: two alternating cap rounds (monotone, idempotent).
  for (int round = 0; round < 2; ++round) {
    for (int i = 0; i < n; ++i) {
      double cap = INF;
      for (int j = 0; j < n; ++j) cap = std::min(cap, S.slack(i, j));
      u[i] = std::min(u[i], cap);
    }
    for (int j = 0; j < n; ++j) {
      double cap = INF;
      for (int i = 0; i < n; ++i) cap = std::min(cap, S.cost(i, j) - u[i]);
      S.v[j] = std::min(S.v[j], cap);
    }
  }

  // Row tightening: u = row-min slack, so every row owns a zero.
  for (int i = 0; i < n; ++i) {
    double m = INF;
    for (int j = 0; j < n; ++j) m = std::min(m, S.slack(i, j));
    u[i] = m;
  }

  const double tight_eps = std::max(eps, 1e-9);

  // Greedy matching on tight edges + global tight-edge count in one pass.
  long long n_tight = 0;
  for (int i = 0; i < n; ++i) {
    bool taken = false;
    for (int j = 0; j < n; ++j) {
      const bool tight = std::fabs(S.slack(i, j) - u[i]) <= tight_eps;
      n_tight += tight;
      if (tight && !taken && S.row_of_col[j] < 0) {
        S.col_of_row[i] = j;
        S.row_of_col[j] = i;
        taken = true;
      }
    }
  }

  vector<int> free_rows;
  for (int i = 0; i < n; ++i)
    if (S.col_of_row[i] < 0) free_rows.push_back(i);

  // The two heuristics fail on complementary families: tight-density
  // under-rates min-trick seeds whose tight structure is sparse (metric),
  // free-rows under-rates tie-heavy seeds where greedy maximal matching
  // flirts with its 1/2 worst case (clustered).  gate 3 falls back only
  // when BOTH deem the seed bad.
  const bool density_bad = (double)n_tight < 1.2 * (double)n;
  const bool free_bad = (double)free_rows.size() > 0.5 * (double)n;
  bool fallback = false;
  if (gate == 0) {
    fallback = density_bad;
  } else if (gate == 1) {
    fallback = free_bad;
  } else if (gate == 3) {
    fallback = density_bad && free_bad;
  }  // gate == 2: never
  if (fallback) {
    // Seed too poor: full cold solve.
    DualState cold(n, C);
    const int rc = solve_cold(cold);
    if (rc != 0) return rc;
    export_solution(cold, x, y, u_out, v_out);
    if (used_fallback) *used_fallback = 1;
    return 0;
  }
  if (used_fallback) *used_fallback = 0;

  // The reference's micro-ARR phase (lapjv_seeded.cpp:134-159) is a
  // provable no-op here: after row tightening u[i] = min_j slack(i, j), a
  // free row's strict argmin column is TIGHT and the greedy pass is
  // maximal, so a free tight column cannot face a free row.  (The removed
  // block also applied the update with the wrong sign — raising v[j1]
  // breaks the nonnegative-reduced-cost invariant Dijkstra relies on —
  // which could never fire, but would have corrupted duals if it had.
  // Mirrors the device-solver removal, solver/seeded.py.)

  const int rc = augment_all(S, free_rows);
  if (rc != 0) return rc;
  export_solution(S, x, y, u_out, v_out);
  return 0;
}


// Dual repair: exact optimality certificate for a candidate assignment,
// without a re-solve.
//
// Given an assignment x claimed optimal for C (e.g. produced by a device
// solve of a LOW-PRECISION copy of C — the bf16-transfer streamed posture)
// and near-feasible column potentials v, drive v to the fixpoint
//     v_k = min(v_k, min_i (C[i,k] + v[x_i] - C[i,x_i]))
// — multi-source shortest paths on the column graph whose arcs leave each
// column j through its matched row row_of_col[j].  With
// u_i = C[i,x_i] - v[x_i] the pair (u, v) is tight on x by construction, so
// reaching the fixpoint proves  min reduced cost >= 0  <=>  x is exactly
// optimal for the TRUE matrix; if x is suboptimal the constraint graph has
// a negative cycle and the relaxation cannot terminate — surfaced as a
// budget blow-up (return -1), never as a false certificate.
//
// Heap-ordered label-correcting: the min-heap keys on (v[k] - v0[k]), so
// the column with the LARGEST decrease from its starting potential (the
// most-negative key) pops first — deepest-first settling, which drains the
// dominant source of further relaxations before its downstream columns are
// scanned.  Warm-started from duals within ~rounding of feasible, columns
// rarely re-relax after popping, so total work is ~2 dense passes over C
// plus a near-empty heap — vs the ~50-100 full Bellman-Ford rounds a cold
// fixpoint needs at n=2048.  (Any pop order converges; the order only
// affects the constant.)
//
// Capability analog in the reference: dual_computation.py:13-74 rebuilds
// duals from an optimal matching by relaxing all n^2 difference constraints
// in Python (cold start, generation-time only).  This is the warm-started
// native equivalent serving the device path's certificate
// (lapgnn_tpu_torch/pipeline.py::_certify_and_polish).
//
// Returns 0 on fixpoint (v updated in place, *min_red_out = exact f64
// minimum reduced cost over all n^2 edges), -1 if the relaxation budget was
// exhausted (x very likely suboptimal; caller should re-solve), -2 on bad
// arguments (including x not being a permutation).
int lapx_repair_duals(int n, const double* C, const int32_t* x, double* v,
                      long long max_scans, double* min_red_out) {
  if (n <= 0 || !C || !x || !v || !min_red_out) return -2;
  vector<int> row_of_col(n, -1);
  for (int i = 0; i < n; ++i) {
    const int j = x[i];
    if (j < 0 || j >= n || row_of_col[j] >= 0) return -2;
    row_of_col[j] = i;
  }
  // Default budget: 64n column scans.  Warm bf16-rounded duals typically
  // need ~2n; the round-4 bench measured instances where 16n bailed on
  // EXACTLY OPTIMAL assignments (forcing a ~170 ms polish for nothing),
  // while 64n repaired every one in ~20 ms.  The budget's only job is to
  // bound the negative-cycle blowup of a genuinely suboptimal assignment:
  // 64n scans * O(n) work is ~0.3 s at n=2048 — still far below the
  // repeated-cold-solve cost the -1 return then avoids.
  if (max_scans <= 0) max_scans = 64LL * n;
  const long long max_pushes = 2 * max_scans;

  vector<double> v0(v, v + n);  // heap keys are decreases vs the start
  using Item = std::pair<double, int>;
  std::priority_queue<Item, vector<Item>, std::greater<Item>> heap;
  long long scans = 0, pushes = 0;

  // Initial full relaxation (row-major friendly): one pass over C seeds the
  // heap with every column the starting potentials fail to dominate.
  for (int i = 0; i < n; ++i) {
    const double* row = C + (size_t)i * n;
    const double w = v[x[i]] - row[x[i]];
    for (int k = 0; k < n; ++k) {
      const double cand = row[k] + w;
      if (cand < v[k]) v[k] = cand;
    }
  }
  scans += n;
  for (int k = 0; k < n; ++k) {
    if (v[k] < v0[k]) {
      heap.emplace(v[k] - v0[k], k);
      ++pushes;
    }
  }

  while (!heap.empty()) {
    const Item top = heap.top();
    heap.pop();
    const int j = top.second;
    if (top.first != v[j] - v0[j]) continue;  // stale entry (lazy deletion)
    if (++scans > max_scans) return -1;
    const int i = row_of_col[j];
    const double* row = C + (size_t)i * n;
    const double w = v[j] - row[j];
    for (int k = 0; k < n; ++k) {
      const double cand = row[k] + w;
      if (cand < v[k]) {
        v[k] = cand;
        if (++pushes > max_pushes) return -1;
        heap.emplace(v[k] - v0[k], k);
      }
    }
  }

  // Certificate pass: exact f64 min reduced cost with u_i = C[i,x_i]-v[x_i].
  // NaN-hostile: any NaN reduced cost must surface as a failed certificate
  // (NaN), never be skipped by a comparison that is false on NaN.
  double min_red = INF;
  bool has_nan = false;
  for (int i = 0; i < n; ++i) {
    const double* row = C + (size_t)i * n;
    const double u_i = row[x[i]] - v[x[i]];
    for (int k = 0; k < n; ++k) {
      const double r = row[k] - u_i - v[k];
      if (r != r) has_nan = true;
      else if (r < min_red) min_red = r;
    }
  }
  *min_red_out = has_nan ? std::numeric_limits<double>::quiet_NaN() : min_red;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse (CSR) solver: the port's copy of lapx_sparse of
// lapgnn_tpu/solver/native/lapx.cpp, the LAPMOD capability. Costs are given
// row-major CSR; absent entries are forbidden edges. Returns -3 if no perfect
// matching on the allowed edges exists.
// ---------------------------------------------------------------------------

namespace {

struct SparseProblem {
  int n;
  const int32_t* row_ptr;  // n+1
  const int32_t* col_idx;  // nnz
  const double* val;       // nnz
};

// Sparse column reduction: every column's potential is its cheapest incident
// edge; rows uniquely claimed keep their edge.
void sparse_column_reduce(const SparseProblem& P, vector<int>& x, vector<int>& y,
                          vector<double>& v) {
  const int n = P.n;
  vector<int> best_row(n, -1);
  for (int j = 0; j < n; ++j) v[j] = INF;
  for (int i = 0; i < n; ++i) {
    for (int32_t k = P.row_ptr[i]; k < P.row_ptr[i + 1]; ++k) {
      const int j = P.col_idx[k];
      if (P.val[k] < v[j]) {
        v[j] = P.val[k];
        best_row[j] = i;
      }
    }
  }
  for (int j = n - 1; j >= 0; --j) {
    const int i = best_row[j];
    if (i >= 0 && x[i] < 0) {
      x[i] = j;
      y[j] = i;
    }
  }
  // Columns no row can reach keep v = 0 so they do not poison the duals.
  for (int j = 0; j < n; ++j)
    if (v[j] == INF) v[j] = 0.0;
}

// Sparse augmenting row reduction (a worklist design).  Each free row takes
// its cheapest column outright, lowering that column's potential by the gap
// to its second-cheapest so the kicked owner re-enters the worklist with a
// usable alternative.  The total number of
// takeovers is bounded (4n) so degenerate cycles (the classic ARR
// infinite-loop bug class) simply hand the leftovers to the exact
// shortest-path phase instead of hanging.
void sparse_arr(const SparseProblem& P, vector<int>& x, vector<int>& y,
                vector<double>& v) {
  const int n = P.n;
  vector<int> work;
  work.reserve(n);
  for (int i = 0; i < n; ++i)
    if (x[i] < 0) work.push_back(i);

  int budget = 4 * n;
  while (!work.empty() && budget-- > 0) {
    const int i = work.back();
    work.pop_back();
    double min1 = INF, min2 = INF;
    int j1 = -1;
    for (int32_t k = P.row_ptr[i]; k < P.row_ptr[i + 1]; ++k) {
      const int j = P.col_idx[k];
      const double r = P.val[k] - v[j];
      if (r < min1) {
        min2 = min1;
        min1 = r;
        j1 = j;
      } else if (r < min2) {
        min2 = r;
      }
    }
    if (j1 < 0) continue;  // row has no edges; path phase will report -3
    if (min2 < INF && min2 > min1) v[j1] -= (min2 - min1);
    const int prev = y[j1];
    if (prev >= 0) {
      // Only evict when strictly profitable for this row (min1 < min2);
      // otherwise leave the row free for the exact phase.
      if (min2 <= min1) continue;
      x[prev] = -1;
      work.push_back(prev);
    }
    x[i] = j1;
    y[j1] = i;
  }
}

// Find-path strategy 1: dense scans — the argmin pass touches every column.
// Wins when rows are dense (most columns get a finite distance anyway).
int sparse_path_scan(const SparseProblem& P, int free_row, vector<int>& x,
                     vector<int>& y, vector<double>& v, vector<double>& d,
                     vector<int>& pred, vector<char>& settled) {
  const int n = P.n;
  std::fill(d.begin(), d.end(), INF);
  std::fill(pred.begin(), pred.end(), free_row);
  std::fill(settled.begin(), settled.end(), 0);

  for (int32_t k = P.row_ptr[free_row]; k < P.row_ptr[free_row + 1]; ++k) {
    const int j = P.col_idx[k];
    d[j] = P.val[k] - v[j];
  }

  int sink = -1;
  double sink_dist = 0.0;
  for (int iter = 0; iter <= n; ++iter) {
    int jmin = -1;
    double dmin = INF;
    for (int j = 0; j < n; ++j) {
      if (!settled[j] && d[j] < dmin) {
        dmin = d[j];
        jmin = j;
      }
    }
    if (jmin < 0) return -3;  // no reachable free column: infeasible

    const int owner = y[jmin];
    if (owner < 0) {
      sink = jmin;
      sink_dist = dmin;
      break;
    }
    settled[jmin] = 1;
    // Slack of the owner at its matched column jmin.
    double owner_match_slack = INF;
    for (int32_t k = P.row_ptr[owner]; k < P.row_ptr[owner + 1]; ++k) {
      if (P.col_idx[k] == jmin) {
        owner_match_slack = P.val[k] - v[jmin];
        break;
      }
    }
    const double base = dmin - owner_match_slack;
    for (int32_t k = P.row_ptr[owner]; k < P.row_ptr[owner + 1]; ++k) {
      const int j = P.col_idx[k];
      if (settled[j]) continue;
      const double cand = base + (P.val[k] - v[j]);
      if (cand < d[j]) {
        d[j] = cand;
        pred[j] = owner;
      }
    }
  }
  if (sink < 0) return -3;

  for (int j = 0; j < n; ++j)
    if (settled[j]) v[j] += d[j] - sink_dist;

  int j = sink;
  for (int guard = 0; guard <= n; ++guard) {
    const int i = pred[j];
    y[j] = i;
    std::swap(x[i], j);
    if (i == free_row) return 0;
  }
  return -1;
}

// Find-path strategy 2: frontier list — only columns that have received a
// finite tentative distance are ever scanned, so per-pop cost tracks the
// reachable set, not n.  Wins on very sparse rows; a lazily-deleted flat
// frontier.
int sparse_path_frontier(const SparseProblem& P, int free_row, vector<int>& x,
                         vector<int>& y, vector<double>& v, vector<double>& d,
                         vector<int>& pred, vector<char>& settled,
                         vector<int>& frontier, vector<char>& in_frontier) {
  const int n = P.n;
  std::fill(d.begin(), d.end(), INF);
  std::fill(pred.begin(), pred.end(), free_row);
  std::fill(settled.begin(), settled.end(), 0);
  std::fill(in_frontier.begin(), in_frontier.end(), 0);
  frontier.clear();

  for (int32_t k = P.row_ptr[free_row]; k < P.row_ptr[free_row + 1]; ++k) {
    const int j = P.col_idx[k];
    d[j] = P.val[k] - v[j];
    if (!in_frontier[j]) {
      in_frontier[j] = 1;
      frontier.push_back(j);
    }
  }

  int sink = -1;
  double sink_dist = 0.0;
  for (int iter = 0; iter <= n; ++iter) {
    int jmin = -1;
    double dmin = INF;
    size_t w = 0;  // compact out settled entries while scanning
    for (size_t r = 0; r < frontier.size(); ++r) {
      const int j = frontier[r];
      if (settled[j]) continue;
      frontier[w++] = j;
      if (d[j] < dmin) {
        dmin = d[j];
        jmin = j;
      }
    }
    frontier.resize(w);
    if (jmin < 0) return -3;

    const int owner = y[jmin];
    if (owner < 0) {
      sink = jmin;
      sink_dist = dmin;
      break;
    }
    settled[jmin] = 1;
    double owner_match_slack = INF;
    for (int32_t k = P.row_ptr[owner]; k < P.row_ptr[owner + 1]; ++k) {
      if (P.col_idx[k] == jmin) {
        owner_match_slack = P.val[k] - v[jmin];
        break;
      }
    }
    const double base = dmin - owner_match_slack;
    for (int32_t k = P.row_ptr[owner]; k < P.row_ptr[owner + 1]; ++k) {
      const int j = P.col_idx[k];
      if (settled[j]) continue;
      const double cand = base + (P.val[k] - v[j]);
      if (cand < d[j]) {
        d[j] = cand;
        pred[j] = owner;
        if (!in_frontier[j]) {
          in_frontier[j] = 1;
          frontier.push_back(j);
        }
      }
    }
  }
  if (sink < 0) return -3;

  // Settled columns all live in (or passed through) the frontier: the dual
  // update only needs to touch reachable columns.
  for (int j = 0; j < n; ++j)
    if (settled[j]) v[j] += d[j] - sink_dist;

  int j = sink;
  for (int guard = 0; guard <= n; ++guard) {
    const int i = pred[j];
    y[j] = i;
    std::swap(x[i], j);
    if (i == free_row) return 0;
  }
  return -1;
}

}  // namespace

extern "C" {

// fp_version: 1 = dense scans, 2 = frontier list, 3 = dynamic (pick by the
// 25% matrix-density threshold).
int lapx_sparse(int n, const int32_t* row_ptr, const int32_t* col_idx,
                const double* val, int32_t* x_out, int32_t* y_out,
                double* u_out, double* v_out, int fp_version) {
  if (n <= 0 || !row_ptr || !col_idx || !val || !x_out || !y_out) return -2;
  SparseProblem P{n, row_ptr, col_idx, val};
  vector<int> x(n, -1), y(n, -1);
  vector<double> v(n, 0.0);

  sparse_column_reduce(P, x, y, v);
  sparse_arr(P, x, y, v);

  int fp = fp_version;
  if (fp != 1 && fp != 2) {
    const double density =
        static_cast<double>(row_ptr[n]) / (static_cast<double>(n) * n);
    fp = density > 0.25 ? 1 : 2;
  }

  vector<double> d(n);
  vector<int> pred(n);
  vector<char> settled(n);
  vector<int> frontier;
  vector<char> in_frontier(n);
  frontier.reserve(n);
  for (int i = 0; i < n; ++i) {
    if (x[i] >= 0) continue;
    const int rc =
        fp == 1 ? sparse_path_scan(P, i, x, y, v, d, pred, settled)
                : sparse_path_frontier(P, i, x, y, v, d, pred, settled,
                                       frontier, in_frontier);
    if (rc != 0) return rc;
  }

  for (int i = 0; i < n; ++i) {
    x_out[i] = x[i];
    if (u_out) {
      double u = 0.0;
      for (int32_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k) {
        if (col_idx[k] == x[i]) {
          u = val[k] - v[col_idx[k]];
          break;
        }
      }
      u_out[i] = u;
    }
  }
  for (int j = 0; j < n; ++j) {
    y_out[j] = y[j];
    if (v_out) v_out[j] = v[j];
  }
  return 0;
}

}  // extern "C"
