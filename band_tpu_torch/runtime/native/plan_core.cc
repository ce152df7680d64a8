// Native planner decision core.
//
// The reference's planner/scheduler layer is native C++ (band/planner.cc,
// band/scheduler/*, and the DP at band/engine.cc:966-1052); this module
// keeps that property for the decision *hot loop* — the
// shortest-expected-latency DP over (unit-boundary, worker) states with
// inter-hop transfer costs — while scheduler policy/orchestration stays
// in Python.  Every latency-aware scheduler (SEL, HEFT, LSF) prices every
// window job through this DP each round, so it is O(window^2) calls per
// planner pass and dominates decision latency.
//
// The Python engine keeps the equivalent reference DP
// (Engine._py_get_subgraph_with_shortest_latency); equivalence is tested
// on randomized instances in tests/test_torch_plan_core.py.
//
// Build: g++ -O2 -shared -fPIC plan_core.cc -o libband_plan-<hash>.so
// into band_tpu_torch/_build/ (done on demand by
// band_tpu_torch/runtime/native/__init__.py).

#include <algorithm>
#include <vector>

namespace {

using i64 = long long;

struct Workers {
  int n;
  const unsigned char* is_host;
  const i64* dev;   // card index (not read for host workers): two
                    // workers on one card share it and hop for free
  const int* proc;  // process that drives the card (0 single-process)
};

// Transfer costing by link class: the same
// (4, 2)-int64 LinkCostTable the Python DP consumes
// (runtime/link_costs.py — row order H2D, HOST, ICI, DCN; row =
// [fixed_us, bytes_per_us]) is passed in by pointer, so the two
// implementations share one source of truth by construction.  The
// reference's in-process memcpy transport is never costed
// (engine.cc:1247-1365).
enum LinkClass { kH2D = 0, kHost = 1, kIci = 2, kDcn = 3 };

inline i64 link_cost(const i64* lc, int cls, i64 nbytes) {
  const i64 per = lc[cls * 2 + 1] > 0 ? lc[cls * 2 + 1] : 1;
  return lc[cls * 2] + nbytes / per;
}

inline i64 xfer_cost(int src, int dst, const Workers& w, i64 nbytes,
                     const i64* lc) {
  if (src < 0 || src == dst) return 0;
  const bool sh = w.is_host[src] != 0, dh = w.is_host[dst] != 0;
  if (sh != dh) return link_cost(lc, kH2D, nbytes);
  if (sh) return link_cost(lc, kHost, nbytes);
  if (w.dev[src] == w.dev[dst]) return 0;  // same card
  if (w.proc[src] != w.proc[dst]) return link_cost(lc, kDcn, nbytes);
  return link_cost(lc, kIci, nbytes);
}

}  // namespace

extern "C" {

// DP over (boundary, last-hop worker) states; memo slot `n_workers`
// encodes "no previous worker" (prev_worker = -1).  Keys must be sorted
// by begin unit (they are built that way at model registration).
// `batch` scales the hop bytes: a batched window's continuation moves
// B x the boundary activations (the execution term is already priced
// per batch bucket by the estimator; the hop term must match).
// Ties between equal-cost paths break as in the Python DP
// (Engine._py_get_subgraph_with_shortest_latency, a dict per boundary):
// the sources of a boundary are visited in the order they were first
// reached, and the first path to reach a state's minimum keeps it.
// Returns the best path's end time, or -1 if no path exists; *out_key
// gets the index of the path's FIRST hop (the subgraph to dispatch now).
i64 band_plan_dp(int num_units, int n_keys, const int* key_begin,
                 const int* key_end, const int* key_worker,
                 const i64* expected_us, const i64* boundary_bytes,
                 int n_workers, const unsigned char* w_is_host,
                 const i64* w_dev, const int* w_proc,
                 const i64* link_costs, const i64* waiting_us,
                 int start_unit, int prev_worker, int batch,
                 int* out_key) {
  *out_key = -1;
  if (start_unit >= num_units) return 0;
  const i64 b = batch > 1 ? batch : 1;
  Workers w{n_workers, w_is_host, w_dev, w_proc};
  const int W = n_workers + 1;  // extra slot: virtual source worker
  std::vector<i64> t((num_units + 1) * W, -1);
  std::vector<int> hop((num_units + 1) * W, -1);
  // when each state was first reached (-1: not yet)
  std::vector<i64> seq((num_units + 1) * W, -1);
  i64 reached = 0;
  const int src0 = prev_worker >= 0 ? prev_worker : n_workers;
  t[start_unit * W + src0] = 0;
  seq[start_unit * W + src0] = reached++;
  // the reached states of one boundary row, in first-reached order
  std::vector<int> order;
  order.reserve(W);
  auto row_order = [&](int row) {
    order.clear();
    for (int j = 0; j < W; ++j)
      if (seq[row * W + j] >= 0) order.push_back(j);
    std::sort(order.begin(), order.end(), [&](int x, int y) {
      return seq[row * W + x] < seq[row * W + y];
    });
  };
  int row = -1;
  for (int k = 0; k < n_keys; ++k) {
    const int begin = key_begin[k];
    if (begin < start_unit) continue;
    // every state of row `begin` is reached before its first key runs
    // (keys are sorted by begin and reach only later rows)
    if (begin != row) {
      row = begin;
      row_order(row);
    }
    i64 expected = expected_us[k];
    if (expected < 0) expected = 0;
    const int kw = key_worker[k];
    const i64 w_wait = waiting_us[kw];
    const int nxt = key_end[k] + 1;
    for (const int j : order) {
      const i64 tj = t[begin * W + j];
      const int src = (j == n_workers) ? -1 : j;
      const i64 x =
          xfer_cost(src, kw, w, boundary_bytes[begin] * b, link_costs);
      i64 arrive = tj + x;
      if (arrive < w_wait) arrive = w_wait;
      const i64 end_time = arrive + expected;
      const int slot = nxt * W + kw;
      if (seq[slot] < 0 || end_time < t[slot]) {
        if (seq[slot] < 0) seq[slot] = reached++;
        t[slot] = end_time;
        const int h = hop[begin * W + j];
        hop[slot] = (h >= 0) ? h : k;
      }
    }
  }
  i64 best = -1;
  row_order(num_units);
  for (const int j : order) {
    const i64 tj = t[num_units * W + j];
    if (best < 0 || tj < best) {
      best = tj;
      *out_key = hop[num_units * W + j];
    }
  }
  return best;
}

}  // extern "C"
