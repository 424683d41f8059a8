// Native exact A* POA alignment engine.
//
// Host-side counterpart of poasta_tpu/aligner/engine.py with identical
// observable semantics (same bucket-queue pop order, greedy match
// extension, bubble pruning, and backtrace tiebreaks), built for raw
// single-core throughput: this is the framework's native runtime for the
// sequential graph-fusion path and the honest baseline for the device
// engine's speedup numbers.  (The reference implements this layer in
// Rust; see src/aligner/astar.rs, dfa.rs, scoring/gap_affine*.rs,
// bubbles/*.rs for the behavioural contract.)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC engine.cpp -o _libpoasta.so
// Binding: ctypes (see poasta_tpu/native/__init__.py).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t kUnvisited = INT32_MAX;

// DP table buffer for the row-pass fills: intentionally UNINITIALIZED.
// The fills write every stored cell of every row before any read (pred
// gathers only read topologically-earlier rows, which are complete;
// the accessor lambdas guard to stored cells), so an INF prefill would
// only double the table memory traffic — measurable at fusion shapes,
// where tables run to ~10^8 cells per call.  Building with
// -DPOASTA_POISON_TABLES poisons fresh buffers instead, which the test
// suite uses to certify the no-read-before-write claim empirically
// (any violated read would shift scores by ~10^9).
template <typename T>
struct RawTable {
  std::unique_ptr<T[]> p;
  explicit RawTable(int64_t n) : p(n > 0 ? new T[n] : nullptr) {
#ifdef POASTA_POISON_TABLES
    for (int64_t i = 0; i < n; ++i) p[i] = (T)0x3BADBEEF;
#endif
  }
  T* data() { return p.get(); }
  const T* data() const { return p.get(); }
  T& operator[](int64_t i) { return p[i]; }
  T operator[](int64_t i) const { return p[i]; }
};

// INF for a table dtype: int16 tables use int16-max itself, so
// std::min(x + cost, INF) IS a saturating add — clamped cells only
// over-estimate, which the verify ladders already treat as "retry".
template <typename T>
constexpr int32_t table_inf() {
  return std::is_same<T, int16_t>::value ? 32767 : (1 << 28);
}

enum State : int { M = 0, D = 1, I = 2, D2 = 3, I2 = 4 };

struct Costs {
  int mismatch;
  int gap_open;
  int gap_extend;
  int gap_open2;
  int gap_extend2;
  bool two_piece;

  // gap_cost for the mingap heuristic (single-piece form; two-piece uses
  // the cheaper piece-2 constants, mirroring the python engine).
  int64_t gap_cost(int state, int64_t length, int o, int e) const {
    if (length == 0) return 0;
    int open = (state == I || state == D) ? 0 : o;
    return open + length * e;
  }

  // the cost model's own gap_cost (python costs.py gap_cost): piece-aware,
  // min over both pieces from a Match state — used by bubble pruning
  int64_t model_gap_cost(int state, int64_t length) const {
    if (length == 0) return 0;
    if (state == I || state == D)
      return (int64_t)gap_open + length * gap_extend;
    if (state == I2 || state == D2)
      return (int64_t)gap_open2 + length * gap_extend2;
    int64_t c1 = (int64_t)gap_open + length * gap_extend;
    if (!two_piece) return c1;
    return std::min(c1, (int64_t)gap_open2 + length * gap_extend2);
  }
};

struct Graph {
  int n;                       // nodes incl. virtual start/end
  const uint8_t* symbols;      // per node id
  // adjacency in iteration order (newest inserted edge first)
  std::vector<std::vector<int32_t>> succs;
  std::vector<std::vector<int32_t>> preds;
  int32_t start_node, end_node;

  bool symbol_equal(int32_t node, uint8_t c) const {
    return node == end_node || symbols[node] == c;
  }
};

// ---------------------------------------------------------------------
// Bubble index (superbubbles + distance bounds), mirroring
// poasta_tpu/bubbles (host precompute; reference: src/bubbles/).
// ---------------------------------------------------------------------

struct BubbleEntry {
  int32_t exit_node;
  int32_t min_dist;
  int32_t max_dist;
};

struct BubbleIndex {
  std::vector<int8_t> is_exit;
  std::vector<std::vector<BubbleEntry>> node_bubbles;
  std::vector<int32_t> min_dist_to_end, max_dist_to_end;
};

static std::vector<int32_t> rev_postorder(const Graph& g) {
  std::vector<int32_t> order;
  order.reserve(g.n);
  std::vector<int8_t> visited(g.n, 0);
  // stack entries: (node, next successor index)
  std::vector<std::pair<int32_t, size_t>> stack;
  stack.push_back({g.start_node, 0});
  while (!stack.empty()) {
    auto& top = stack.back();
    const auto& succ = g.succs[top.first];
    bool descended = false;
    while (top.second < succ.size()) {
      int32_t child = succ[top.second++];
      if (!visited[child]) {
        visited[child] = 1;
        stack.push_back({child, 0});
        descended = true;
        break;
      }
    }
    if (!descended && stack.back().second >= g.succs[stack.back().first].size()) {
      order.push_back(stack.back().first);
      stack.pop_back();
    }
  }
  std::reverse(order.begin(), order.end());
  return order;
}

static BubbleIndex build_bubble_index(const Graph& g) {
  BubbleIndex bi;
  bi.is_exit.assign(g.n, 0);
  bi.node_bubbles.assign(g.n, {});
  bi.min_dist_to_end.assign(g.n, 0);
  bi.max_dist_to_end.assign(g.n, 0);

  std::vector<int32_t> inv = rev_postorder(g);
  std::vector<int32_t> rpo(g.n, 0);
  for (size_t i = 0; i < inv.size(); ++i) rpo[inv[i]] = (int32_t)i;

  constexpr int64_t NEG = -1, POS = INT64_MAX;
  std::vector<int64_t> out_parent(g.n), out_child(g.n);
  for (int v = 0; v < g.n; ++v) {
    int64_t mn = NEG;
    bool first = true;
    for (int32_t p : g.preds[v]) {
      if (first || rpo[p] < mn) mn = rpo[p];
      first = false;
    }
    out_parent[v] = first ? NEG : mn;
    int64_t mx = POS;
    first = true;
    for (int32_t s : g.succs[v]) {
      if (first || rpo[s] > mx) mx = rpo[s];
      first = false;
    }
    out_child[v] = first ? POS : mx;
  }

  // superbubble enumeration (Gaertner et al. style sweep)
  std::vector<std::pair<int32_t, int32_t>> bubbles;  // (entrance, exit)
  {
    std::unordered_map<int32_t, int64_t> opm;
    std::vector<int32_t> stack;
    int32_t candidate = -1;
    for (int64_t curr = (int64_t)inv.size() - 1; curr >= 0; --curr) {
      int32_t n = inv[curr];
      int64_t fc = out_child[n];
      std::pair<int32_t, int32_t> ret{-1, -1};

      if (fc == curr + 1) {
        if (candidate != -1) stack.push_back(candidate);
        candidate = inv[curr + 1];
      } else {
        while (candidate != -1) {
          if (fc <= rpo[candidate]) break;
          int32_t prev = candidate;
          candidate = stack.empty() ? -1 : stack.back();
          if (!stack.empty()) stack.pop_back();
          if (candidate != -1) {
            int64_t np = std::min(opm[prev], opm[candidate]);
            opm[candidate] = np;
          }
        }
      }

      if (candidate != -1 && opm.count(candidate) && opm[candidate] == curr) {
        ret = {n, candidate};
        int32_t prev = candidate;
        candidate = stack.empty() ? -1 : stack.back();
        if (!stack.empty()) stack.pop_back();
        if (candidate != -1) {
          int64_t np = std::min(opm[prev], opm[candidate]);
          opm[candidate] = np;
        }
      }

      opm[n] = out_parent[n];
      if (candidate != -1) {
        opm[candidate] = std::min(opm[n], opm[candidate]);
      }
      if (ret.first != -1) bubbles.push_back(ret);
    }
  }

  std::vector<int32_t> entrance_of(g.n, -1), exit_of(g.n, -1);
  for (auto& [ent, ex] : bubbles) {
    entrance_of[ent] = ex;
    exit_of[ex] = ent;
    bi.is_exit[ex] = 1;
  }

  // backward BFS from the end node with an active-bubble stack
  {
    std::vector<int8_t> visited(g.n, 0);
    struct Item {
      int32_t node;
      int32_t dist;
      std::vector<std::pair<int32_t, int32_t>> stack;  // (dist, exit)
    };
    std::deque<Item> queue;
    std::vector<std::pair<int32_t, int32_t>> init;
    if (exit_of[g.end_node] != -1) init.push_back({0, g.end_node});
    queue.push_back({g.end_node, 0, init});
    visited[g.end_node] = 1;
    while (!queue.empty()) {
      Item it = std::move(queue.front());
      queue.pop_front();
      for (auto& [bd, ex] : it.stack)
        bi.node_bubbles[it.node].push_back({ex, it.dist - bd, 0});
      bi.min_dist_to_end[it.node] = it.dist;
      for (int32_t pred : g.preds[it.node]) {
        if (!visited[pred]) {
          int32_t nd = it.dist + 1;
          auto ns = it.stack;
          if (entrance_of[pred] != -1) {
            auto [bd, ex] = ns.back();
            ns.pop_back();
            bi.node_bubbles[pred].push_back({ex, nd - bd, 0});
          }
          if (exit_of[pred] != -1) ns.push_back({nd, pred});
          visited[pred] = 1;
          queue.push_back({pred, nd, std::move(ns)});
        }
      }
    }
  }

  // longest path to end by postorder sweep + bubble max dists
  for (auto it = inv.rbegin(); it != inv.rend(); ++it) {
    int32_t n = *it, mx = 0;
    for (int32_t s : g.succs[n]) mx = std::max(mx, bi.max_dist_to_end[s] + 1);
    bi.max_dist_to_end[n] = mx;
    for (auto& b : bi.node_bubbles[n])
      b.max_dist = mx - bi.max_dist_to_end[b.exit_node];
  }
  return bi;
}

// ---------------------------------------------------------------------
// Visited store + bubble pruning
// ---------------------------------------------------------------------

struct Cell {
  int32_t s[5] = {kUnvisited, kUnvisited, kUnvisited, kUnvisited, kUnvisited};
};

struct Visited {
  std::unordered_map<int64_t, Cell> cells;
  std::vector<std::vector<int32_t>> reached;  // sorted offsets per exit node
  const Graph* g;
  const BubbleIndex* bi;
  const Costs* c;
  int64_t seq_len;

  static int64_t key(int32_t node, int32_t off) {
    return ((int64_t)node << 32) | (uint32_t)off;
  }
  int32_t get(int32_t node, int32_t off, int st) const {
    auto it = cells.find(key(node, off));
    return it == cells.end() ? kUnvisited : it->second.s[st];
  }
  void set(int32_t node, int32_t off, int st, int32_t sc) {
    cells[key(node, off)].s[st] = sc;
  }
  bool update_if_lower(int32_t node, int32_t off, int st, int32_t sc) {
    auto& cell = cells[key(node, off)];
    if (sc < cell.s[st]) {
      cell.s[st] = sc;
      return true;
    }
    return false;
  }
  void mark_reached(int32_t node, int32_t off, int st) {
    if (st == M && bi->is_exit[node]) {
      auto& v = reached[node];
      auto it = std::lower_bound(v.begin(), v.end(), off);
      if (it == v.end() || *it != off) v.insert(it, off);
    }
  }

  bool can_improve_at(int32_t exit_node, int64_t off, int64_t score,
                      const int32_t* left, const int32_t* right,
                      int64_t min_dist_end) const {
    bool have = false;
    int64_t implicit = 0;
    if (left && right) {
      int64_t ls = get(exit_node, *left, M);
      int64_t rs = get(exit_node, *right, M);
      int64_t fl = ls + c->model_gap_cost(M, off - *left);
      int64_t fr = rs + c->model_gap_cost(M, *right - off);
      implicit = (*right - off > min_dist_end) ? fl : std::min(fl, fr);
      have = true;
    } else if (right) {
      if (*right - off <= min_dist_end) {
        int64_t rs = get(exit_node, *right, M);
        implicit = rs + c->model_gap_cost(M, *right - off);
        have = true;
      }
    } else if (left) {
      int64_t ls = get(exit_node, *left, M);
      implicit = ls + c->model_gap_cost(M, off - *left);
      have = true;
    }
    return !have || score < implicit;
  }

  bool can_improve_bubble(const BubbleEntry& b, int32_t node, int32_t off,
                          int st, int64_t score) const {
    const auto& r = reached[b.exit_node];
    if (r.empty()) return true;
    if (node == b.exit_node) return true;

    int64_t tmin = off + b.min_dist;
    int64_t tmax = off + b.max_dist;
    int64_t mde = std::max<int64_t>(bi->min_dist_to_end[b.exit_node] - 1, 0);
    if (tmax > seq_len) return true;

    auto lo = std::lower_bound(r.begin(), r.end(), (int32_t)tmin);
    const int32_t* prev = (lo == r.begin()) ? nullptr : &*(lo - 1);

    bool have_last = false;
    int64_t last_off = 0;
    for (auto it = lo; it != r.end() && *it <= tmax; ++it) {
      int32_t nxt = *it;
      int64_t off1 = prev ? std::max(tmin, (int64_t)*prev + 1) : tmin;

      if (st == D) {
        if ((int64_t)get(b.exit_node, nxt, M) + c->gap_open > score) return true;
      } else if (st == D2) {
        if ((int64_t)get(b.exit_node, nxt, M) + c->gap_open2 > score) return true;
      }
      if (prev) {
        if (st == I) {
          if ((int64_t)get(b.exit_node, *prev, M) + c->gap_open > score) return true;
        } else if (st == I2) {
          if ((int64_t)get(b.exit_node, *prev, M) + c->gap_open2 > score) return true;
        }
      }

      if (can_improve_at(b.exit_node, off1, score, prev, &nxt, mde)) return true;
      int64_t off2 = std::min(tmax, std::max(tmin, (int64_t)nxt - 1));
      if (off2 != off1 &&
          can_improve_at(b.exit_node, off2, score, prev, &nxt, mde))
        return true;

      prev = &*it;
      last_off = off2;
      have_last = true;
    }

    auto hi = std::upper_bound(r.begin(), r.end(), (int32_t)tmax);
    const int32_t* nxt = (hi == r.end()) ? nullptr : &*hi;

    if (!have_last && can_improve_at(b.exit_node, tmin, score, prev, nxt, mde))
      return true;
    if ((!have_last || last_off < tmax) &&
        can_improve_at(b.exit_node, tmax, score, prev, nxt, mde))
      return true;

    if (prev) {
      if (st == I) {
        if ((int64_t)get(b.exit_node, *prev, M) + c->gap_open > score) return true;
      } else if (st == I2) {
        if ((int64_t)get(b.exit_node, *prev, M) + c->gap_open2 > score) return true;
      }
    }
    return false;
  }

  bool prune(int32_t node, int32_t off, int st, int64_t score) const {
    if (bi->node_bubbles[node].empty()) return false;
    for (const auto& b : bi->node_bubbles[node])
      if (!can_improve_bubble(b, node, off, st, score)) return true;
    return false;
  }
};

// ---------------------------------------------------------------------
// Bucket queue (f-layered, per-state sub-queues per layer).
//
// Gap-affine: drained FIFO with pop order D, I, M — the discipline that
// reproduces the published truth MSAs' co-optimal tiebreaks byte-for-byte
// (see poasta_tpu/aligner/engine.py::_LayeredQueue for the derivation).
// Two-piece: current-reference order (LIFO; M, D, D2, I, I2 —
// reference gap_affine_2piece.rs:1069-1089); no published truth exists.
// ---------------------------------------------------------------------

struct QueueItem {
  int32_t score, node, offset;
};

struct Layer {
  std::deque<QueueItem> st[5];
  bool empty() const {
    return st[0].empty() && st[1].empty() && st[2].empty() && st[3].empty() &&
           st[4].empty();
  }
};

struct BucketQueue {
  std::deque<Layer> layers;
  int64_t layer_min = 0;
  bool two_piece = false;
  static constexpr int pop_order_affine[5] = {D, I, M, D2, I2};
  static constexpr int pop_order_2piece[5] = {M, D, D2, I, I2};

  void push(int32_t node, int32_t off, int st, int32_t score, int64_t h) {
    int64_t pri = score + h;
    if (layers.empty()) {
      layers.emplace_back();
      layer_min = pri;
    } else {
      int64_t layer_max = layer_min + (int64_t)layers.size();
      if (pri < layer_min) {
        for (int64_t i = 0; i < layer_min - pri; ++i) layers.emplace_front();
        layer_min = pri;
      } else if (pri >= layer_max) {
        int64_t need = pri - layer_min + 1;
        while ((int64_t)layers.size() < need) layers.emplace_back();
      }
    }
    layers[pri - layer_min].st[st].push_back({score, node, off});
  }

  bool pop(QueueItem* out, int* state) {
    if (layers.empty()) return false;
    Layer& l = layers.front();
    bool found = false;
    const int* order = two_piece ? pop_order_2piece : pop_order_affine;
    for (int i = 0; i < 5; ++i) {
      int s = order[i];
      if (!l.st[s].empty()) {
        if (two_piece) {
          *out = l.st[s].back();
          l.st[s].pop_back();
        } else {
          *out = l.st[s].front();
          l.st[s].pop_front();
        }
        *state = s;
        found = true;
        break;
      }
    }
    while (!layers.empty() && layers.front().empty()) {
      layers.pop_front();
      ++layer_min;
    }
    return found;
  }
};

// ---------------------------------------------------------------------
// Engine
// ---------------------------------------------------------------------

struct Engine {
  Graph g;
  BubbleIndex bi;
  std::vector<int32_t> node_storage;  // backing for adjacency (unused)

  // banded-fill metadata, built lazily on first poasta_align_banded call
  bool banded_ready = false;
  std::mutex meta_mu;  // callers run concurrently with the GIL released
  std::vector<int32_t> topo;       // rank -> node id (start first, end last)
  std::vector<int64_t> ds_min, ds_max;  // min/max edge dist from start, by node
};

static void ensure_banded_meta(Engine& eng) {
  std::lock_guard<std::mutex> lk(eng.meta_mu);
  if (eng.banded_ready) return;
  const Graph& g = eng.g;
  // Kahn toposort
  std::vector<int32_t> indeg(g.n, 0);
  for (int32_t v = 0; v < g.n; ++v)
    for (int32_t s : g.succs[v]) indeg[s]++;
  std::deque<int32_t> q;
  for (int32_t v = 0; v < g.n; ++v)
    if (indeg[v] == 0) q.push_back(v);
  eng.topo.clear();
  eng.topo.reserve(g.n);
  while (!q.empty()) {
    int32_t v = q.front();
    q.pop_front();
    eng.topo.push_back(v);
    for (int32_t s : g.succs[v])
      if (--indeg[s] == 0) q.push_back(s);
  }
  // min/max edge distance from the start, forward sweep in topo order
  // (mirrors poasta_tpu/graphs/flat.py:139-151)
  constexpr int64_t BIG = INT32_MAX / 4;
  eng.ds_min.assign(g.n, BIG);
  eng.ds_max.assign(g.n, 0);
  eng.ds_min[g.start_node] = 0;
  for (int32_t v : eng.topo) {
    if (v == g.start_node) continue;
    int64_t mn = BIG, mx = 0;
    for (int32_t p : g.preds[v]) {
      mn = std::min(mn, eng.ds_min[p] + 1);
      mx = std::max(mx, eng.ds_max[p] + 1);
    }
    if (g.preds[v].empty()) mn = mx = 0;
    eng.ds_min[v] = mn;
    eng.ds_max[v] = mx;
  }
  eng.banded_ready = true;
}

struct AlignParams {
  Costs costs;
  int heuristic;  // 0 = dijkstra, 1 = mingap
};

static int64_t heuristic_h(const Engine& eng, const AlignParams& p,
                           int32_t node, int64_t off, int st, int64_t seq_len) {
  if (p.heuristic == 0) return 0;
  // mingap; two-piece uses the cheaper piece-2 constants
  int o = p.costs.two_piece ? p.costs.gap_open2 : p.costs.gap_open;
  int e = p.costs.two_piece ? p.costs.gap_extend2 : p.costs.gap_extend;
  int64_t mind = std::max<int64_t>(eng.bi.min_dist_to_end[node] - 1, 0);
  int64_t maxd = std::max<int64_t>(eng.bi.max_dist_to_end[node] - 1, 0);
  int64_t tmin = off + mind, tmax = off + maxd;
  int64_t gap;
  int state = st;
  if (tmin > seq_len) {
    gap = tmin - seq_len;
    if (state != D) state = M;
  } else if (tmax < seq_len) {
    gap = seq_len - tmax;
    if (state != I) state = M;
  } else {
    gap = 0;
  }
  return p.costs.gap_cost(state, gap, o, e);
}

struct BtStep {
  int32_t node, offset;
  int state;
  bool ok;
};

static BtStep backtrace_step(const Engine& eng, const Visited& v,
                             const Costs& c, const uint8_t* seq, int64_t n,
                             int32_t node, int32_t off, int st) {
  const Graph& g = eng.g;
  int32_t cur = v.get(node, off, st);
  if (cur == kUnvisited) return {0, 0, 0, false};

  // oldest-inserted-edge-first predecessor order for candidate scans
  auto preds_oldest = [&](int32_t nd) {
    std::vector<int32_t> r(g.preds[nd].rbegin(), g.preds[nd].rend());
    return r;
  };

  if (st == M) {
    if (off > 0) {
      bool match_or_end =
          g.symbol_equal(node, seq[off - 1]) || node == g.end_node;
      int32_t pred_off = (node == g.end_node) ? off : off - 1;
      for (int32_t p : preds_oldest(node)) {
        int32_t ps = v.get(p, pred_off, M);
        if (ps == kUnvisited) continue;
        if ((match_or_end && ps == cur) ||
            (!match_or_end && ps == cur - c.mismatch))
          return {p, pred_off, M, true};
      }
    }
    if (v.get(node, off, D) == cur) return {node, off, D, true};
    if (c.two_piece && v.get(node, off, D2) == cur) return {node, off, D2, true};
    if (v.get(node, off, I) == cur) return {node, off, I, true};
    if (c.two_piece && v.get(node, off, I2) == cur) return {node, off, I2, true};
  } else if (st == D) {
    for (int32_t p : preds_oldest(node))
      if (v.get(p, off, M) == cur - c.gap_open - c.gap_extend)
        return {p, off, M, true};
    for (int32_t p : preds_oldest(node))
      if (v.get(p, off, D) == cur - c.gap_extend) return {p, off, D, true};
  } else if (st == D2) {
    for (int32_t p : preds_oldest(node))
      if (v.get(p, off, D) == cur - c.gap_extend2) return {p, off, D, true};
    for (int32_t p : preds_oldest(node))
      if (v.get(p, off, D2) == cur - c.gap_extend2) return {p, off, D2, true};
  } else if (st == I) {
    if (off > 0) {
      if (v.get(node, off - 1, M) == cur - c.gap_open - c.gap_extend)
        return {node, off - 1, M, true};
      if (v.get(node, off - 1, I) == cur - c.gap_extend)
        return {node, off - 1, I, true};
    }
  } else {  // I2
    if (off > 0) {
      if (v.get(node, off - 1, I) == cur - c.gap_extend2)
        return {node, off - 1, I, true};
      if (v.get(node, off - 1, I2) == cur - c.gap_extend2)
        return {node, off - 1, I2, true};
    }
  }
  return {0, 0, 0, false};
}

// Last-call phase breakdown of poasta_align_anchored (see the extern
// "C" accessor): {corridor_ns, fill_ns, backtrace_ns, corridor_nodes,
// corridor_cells, attempts}.  Thread-local: each pool worker reads its
// own calls' stats.
thread_local int64_t g_anchor_stats[6];


// Shared row-pass DP fill over windowed rows — the core of BOTH
// align_banded_impl and align_anchored_impl (they differ only in row
// indexing, pred-window lookup, and origin semantics, injected via the
// functors).  Per row: (1) gather predecessor M/D row minima into
// contiguous scratch rows over each pred's overlap segment (branch-free
// min loops the compiler auto-vectorizes), (2) compute the D and
// match-dependent A rows vectorized over offsets, (3) the affine
// insertion closure — tilted one-piece form (I[k] = o + e*k +
// min_{m<k}(A[m] - e*m), int64 accumulators, kBig lifts INF/saturated
// lanes so erosion by e*m can never dip below the clamp; stored values
// identical to the clamped serial chain min(A[k-1]+o+e, I[k-1]+e, INF))
// or the coupled two-piece chain
//   I1[j] = min(A[j-1]+o+e, I1[j-1]+e, I2[j-1]+o+e)
//   I2[j] = min(I1[j-1], I2[j-1]) + e2
// whose closures interlock through both extend rates.  All values are
// re-clamped to INF; for int16 tables that clamp IS a saturating add
// whose over-estimates the verify ladders absorb.  NB round 1 measured
// a DIFFERENT restructure (full-row masked temporaries re-scanned per
// pred) 3x slower; this overlap-segment row pass measured ~3x faster
// on the anchored corridor (A/B: scripts/native_banded_bench.py).
//
// Functors:
//   row_node(i)                         node id of row i (topo order)
//   row_window(i, nd, &jlo, &jhi, &rb)  window + storage offset of row
//                                       i; false skips the row
//   pred_window(p, &plo, &phi, &pb)     same for a predecessor NODE;
//                                       false = no stored row (outside
//                                       a corridor)
//   origin_at(nd)                       rows whose j=0 cell is a free
//                                       origin (A = 0)
template <typename T, typename RowNode, typename RowWin, typename PredWin,
          typename OriginAt>
void fill_rows(const Graph& g, const uint8_t* seq, int32_t o, int32_t e,
               int32_t x, int32_t e2, bool tp, int32_t INF, int32_t nr,
               RowNode row_node, RowWin row_window, PredWin pred_window,
               OriginAt origin_at, RawTable<T>& Mb, RawTable<T>& Ib,
               RawTable<T>& Db, RawTable<T>& I2b, RawTable<T>& D2b) {
  int64_t maxw = 0;
  for (int32_t i = 0; i < nr; ++i) {
    int64_t jlo, jhi, rb;
    if (row_window(i, row_node(i), jlo, jhi, rb))
      maxw = std::max(maxw, jhi - jlo + 1);
  }
  // pmrow[k] = min over preds of M[lo-1+k] (one extra lane on the left
  // so the diagonal term reads pmrow[k] = pred_M[j-1])
  std::vector<T> pmrow(maxw + 1), pdrow(maxw), pd2row, Arow(maxw);
  if (tp) pd2row.resize(maxw);
  for (int32_t i = 0; i < nr; ++i) {
    const int32_t nd = row_node(i);
    int64_t jlo, jhi, rb;
    if (!row_window(i, nd, jlo, jhi, rb)) continue;
    const bool is_end = nd == g.end_node;
    const bool origin = origin_at(nd);
    const int32_t sym = g.symbols[nd];
    const int64_t w = jhi - jlo + 1;
    std::fill(pmrow.begin(), pmrow.begin() + w + 1, INF);
    std::fill(pdrow.begin(), pdrow.begin() + w, INF);
    if (tp) std::fill(pd2row.begin(), pd2row.begin() + w, INF);
    for (int32_t p : g.preds[nd]) {
      int64_t plo, phi, pb;
      if (!pred_window(p, plo, phi, pb)) continue;
      const int64_t b = pb - plo;
      const T* prM = Mb.data() + b;
      const T* prD = Db.data() + b;
      // M overlap over [jlo-1, jhi] (feeds both same-j and diagonal)
      const int64_t ms = std::max(jlo - 1, plo);
      const int64_t me = std::min(jhi, phi);
      T* pm = pmrow.data() + 1 - jlo;  // pm[j] = pmrow[j-(jlo-1)]
      for (int64_t j = ms; j <= me; ++j)
        pm[j] = std::min(pm[j], prM[j]);
      const int64_t ds = std::max(jlo, plo);
      T* pd = pdrow.data() - jlo;
      for (int64_t j = ds; j <= me; ++j)
        pd[j] = std::min(pd[j], prD[j]);
      if (tp) {
        const T* prD2 = D2b.data() + b;
        T* pd2 = pd2row.data() - jlo;
        for (int64_t j = ds; j <= me; ++j)
          pd2[j] = std::min(pd2[j], prD2[j]);
      }
    }
    const int64_t bI = rb - jlo;
    T* Mrow = Mb.data() + bI;
    T* Irow = Ib.data() + bI;
    T* Drow = Db.data() + bI;
    T* I2row = tp ? I2b.data() + bI : nullptr;
    T* D2row = tp ? D2b.data() + bI : nullptr;
    if (is_end) {
      // virtual end: zero-cost same-offset hop from the best pred M
      for (int64_t k = 0; k < w; ++k) {
        Mrow[jlo + k] = pmrow[k + 1];
        Irow[jlo + k] = INF;
        Drow[jlo + k] = INF;
      }
      if (tp)
        for (int64_t k = 0; k < w; ++k) {
          I2row[jlo + k] = INF;
          D2row[jlo + k] = INF;
        }
      continue;
    }
    if (!tp) {
      for (int64_t k = 0; k < w; ++k)
        Drow[jlo + k] = std::min(
            std::min(pmrow[k + 1] + (o + e), pdrow[k] + e), INF);
    } else {
      for (int64_t k = 0; k < w; ++k) {
        Drow[jlo + k] = std::min(
            std::min(pmrow[k + 1] + (o + e), pdrow[k] + e), INF);
        D2row[jlo + k] =
            std::min(std::min(pdrow[k], pd2row[k]) + e2, INF);
      }
    }
    // A row: diagonal + match cost vs D (and D2); query byte compares
    // are per-offset and branch-free
    {
      const int64_t k0 = jlo == 0 ? 1 : 0;  // j>=1 guard
      if (jlo == 0)
        Arow[0] = origin
            ? 0
            : std::min<int32_t>(Drow[jlo], tp ? (int32_t)D2row[jlo] : INF);
      const uint8_t* sq = seq + (jlo + k0 - 1);  // sq[k-k0] = seq[jlo+k-1]
      for (int64_t k = k0; k < w; ++k) {
        const int32_t match = (sym == (int32_t)sq[k - k0]) ? 0 : x;
        const int32_t diag = std::min(pmrow[k] + match, INF);
        const int32_t dv = tp ? std::min(Drow[jlo + k], D2row[jlo + k])
                              : Drow[jlo + k];
        Arow[k] = std::min(diag, dv);
      }
    }
    // affine insertion closure + M (see the function comment)
    int32_t prevA = INF, prevI = INF, prevI2 = INF;
    if (!tp) {
      constexpr int64_t kBig = (int64_t)1 << 55;
      int64_t rm = kBig;  // min over m<k of tilted A
      int64_t ek = 0;     // e * k (int64: e*w can pass 2^31)
      for (int64_t k = 0; k < w; ++k, ek += e) {
        const int32_t Iv = (int32_t)std::min<int64_t>(rm + o + ek, INF);
        Irow[jlo + k] = Iv;
        Mrow[jlo + k] = std::min<int32_t>(Arow[k], Iv);
        const int64_t a = Arow[k];
        rm = std::min(rm, (a >= INF ? kBig : a) - ek);
      }
    } else {
      for (int64_t k = 0; k < w; ++k) {
        const int32_t Iv = std::min(
            std::min(std::min(prevA, prevI2) + (o + e), prevI + e), INF);
        const int32_t I2v = std::min(std::min(prevI, prevI2) + e2, INF);
        Irow[jlo + k] = Iv;
        I2row[jlo + k] = I2v;
        Mrow[jlo + k] = std::min<int32_t>(Arow[k], std::min(Iv, I2v));
        prevA = Arow[k];
        prevI = Iv;
        prevI2 = I2v;
      }
    }
  }
}

template <typename T>
int64_t align_banded_impl(void* ptr, const uint8_t* seq, int64_t n,
                            int32_t mismatch, int32_t gap_open,
                            int32_t gap_extend, int32_t gap_extend2,
                            int32_t two_piece, int64_t ub,
                            int32_t* out_rpos, int32_t* out_qpos, int64_t cap,
                            int64_t* out_score) {
  auto& eng = *static_cast<Engine*>(ptr);
  const Graph& g = eng.g;
  ensure_banded_meta(eng);
  const int32_t o = gap_open, e = gap_extend, x = mismatch;
  const int32_t e2 = gap_extend2;
  const bool tp = two_piece != 0;
  const int32_t INF = table_inf<T>();
  // the row-pass fill clamps INF + cost in int32; bound the costs so
  // that can't overflow (any real scoring scheme is orders below this)
  if (o > (1 << 20) || e > (1 << 20) || x > (1 << 20) || e2 > (1 << 20))
    return -5;

  // per-node windows [lo, hi] (query offsets), width prefix offsets.
  // K = max gap length whose cheapest cost fits under ub; for two-piece
  // the cheapest long gap is open + switch-to-piece-2, so dividing by e2
  // over-covers (safe: a wider band only costs work, never exactness).
  const int64_t cheap_e = tp ? e2 : e;
  const int64_t K = (ub >= o + cheap_e) ? (ub - o) / cheap_e : 0;
  std::vector<int64_t> lo(g.n), hi(g.n), base(g.n + 1, 0);
  for (int32_t r = 0; r < g.n; ++r) {
    int32_t nd = eng.topo[r];
    int64_t de_min = eng.bi.min_dist_to_end[nd];
    int64_t de_max = eng.bi.max_dist_to_end[nd];
    int64_t l = std::max<int64_t>(
        0, std::max(eng.ds_min[nd] - K, (n - de_max + 1) - K));
    // a node deeper than n + K has l > n; clamp so the fill never reads
    // seq[] past the query (offsets > n cannot be on any path to (end, n))
    l = std::min<int64_t>(l, n);
    int64_t h = std::min<int64_t>(
        n, std::min(eng.ds_max[nd] + K, (n - de_min + 1) + K));
    h = std::max(h, l);
    lo[nd] = l;
    hi[nd] = h;
  }
  for (int32_t nd = 0; nd < g.n; ++nd) base[nd + 1] = hi[nd] - lo[nd] + 1;
  for (int32_t nd = 0; nd < g.n; ++nd) base[nd + 1] += base[nd];
  const int64_t total = base[g.n];
  RawTable<T> Mb(total), Ib(total), Db(total);
  RawTable<T> I2b(tp ? total : 0), D2b(tp ? total : 0);

  auto idx = [&](int32_t nd, int64_t j) -> int64_t {
    return base[nd] + (j - lo[nd]);
  };
  auto in_band = [&](int32_t nd, int64_t j) -> bool {
    return j >= lo[nd] && j <= hi[nd];
  };
  auto getM = [&](int32_t nd, int64_t j) -> int32_t {
    return in_band(nd, j) ? Mb[idx(nd, j)] : INF;
  };
  auto getI = [&](int32_t nd, int64_t j) -> int32_t {
    return in_band(nd, j) ? Ib[idx(nd, j)] : INF;
  };
  auto getD = [&](int32_t nd, int64_t j) -> int32_t {
    return in_band(nd, j) ? Db[idx(nd, j)] : INF;
  };
  auto getI2 = [&](int32_t nd, int64_t j) -> int32_t {
    return (tp && in_band(nd, j)) ? I2b[idx(nd, j)] : INF;
  };
  auto getD2 = [&](int32_t nd, int64_t j) -> int32_t {
    return (tp && in_band(nd, j)) ? D2b[idx(nd, j)] : INF;
  };

  // fill in topological order (row semantics of ops/dp_rows*.py).
  fill_rows<T>(
      g, seq, o, e, x, e2, tp, INF, g.n,
      [&](int32_t i) { return eng.topo[i]; },
      [&](int32_t, int32_t nd, int64_t& jlo, int64_t& jhi, int64_t& rb) {
        jlo = lo[nd];
        jhi = hi[nd];
        rb = base[nd];
        return true;
      },
      [&](int32_t p, int64_t& plo, int64_t& phi, int64_t& pb) {
        plo = lo[p];
        phi = hi[p];
        pb = base[p];
        return true;
      },
      [&](int32_t nd) { return nd == g.start_node; }, Mb, Ib, Db, I2b,
      D2b);

  int64_t score = getM(g.end_node, n);
  out_score[0] = score;
  if (score > ub) return -4;
  if (n == 0) return 0;

  // backtrace — mirrors wavefront.py backtrace_dense (extended with the
  // two-piece states' transition structure from engine.py backtrace_step)
  auto preds_oldest = [&](int32_t nd) {
    return std::vector<int32_t>(g.preds[nd].rbegin(), g.preds[nd].rend());
  };

  int64_t j = n;
  int32_t cur = (int32_t)score;
  int32_t node = -1;
  for (int32_t p : preds_oldest(g.end_node))
    if (getM(p, j) == cur) {
      node = p;
      break;
    }
  if (node < 0) return -3;
  int state = M;

  std::vector<std::pair<int32_t, int32_t>> pairs;
  while (true) {
    switch (state) {
      case M: cur = getM(node, j); break;
      case D: cur = getD(node, j); break;
      case I: cur = getI(node, j); break;
      case D2: cur = getD2(node, j); break;
      default: cur = getI2(node, j); break;
    }
    int32_t bt_node = -1;
    int64_t bt_j = 0;
    int bt_state = M;
    if (state == M) {
      if (j > 0) {
        int32_t want = g.symbol_equal(node, seq[j - 1]) ? cur : cur - x;
        for (int32_t p : preds_oldest(node))
          if (getM(p, j - 1) == want) {
            bt_node = p;
            bt_j = j - 1;
            bt_state = M;
            break;
          }
      }
      if (bt_node < 0 && getD(node, j) == cur) {
        bt_node = node; bt_j = j; bt_state = D;
      }
      if (tp && bt_node < 0 && getD2(node, j) == cur) {
        bt_node = node; bt_j = j; bt_state = D2;
      }
      if (bt_node < 0 && getI(node, j) == cur) {
        bt_node = node; bt_j = j; bt_state = I;
      }
      if (tp && bt_node < 0 && getI2(node, j) == cur) {
        bt_node = node; bt_j = j; bt_state = I2;
      }
    } else if (state == D) {
      for (int32_t p : preds_oldest(node))
        if (getM(p, j) == cur - o - e) {
          bt_node = p; bt_j = j; bt_state = M;
          break;
        }
      if (bt_node < 0)
        for (int32_t p : preds_oldest(node))
          if (getD(p, j) == cur - e) {
            bt_node = p; bt_j = j; bt_state = D;
            break;
          }
    } else if (state == D2) {
      for (int32_t p : preds_oldest(node))
        if (getD(p, j) == cur - e2) {
          bt_node = p; bt_j = j; bt_state = D;
          break;
        }
      if (bt_node < 0)
        for (int32_t p : preds_oldest(node))
          if (getD2(p, j) == cur - e2) {
            bt_node = p; bt_j = j; bt_state = D2;
            break;
          }
    } else if (state == I) {
      if (j > 0) {
        if (getM(node, j - 1) == cur - o - e) {
          bt_node = node; bt_j = j - 1; bt_state = M;
        } else if (getI(node, j - 1) == cur - e) {
          bt_node = node; bt_j = j - 1; bt_state = I;
        } else if (tp && getI2(node, j - 1) == cur - o - e) {
          bt_node = node; bt_j = j - 1; bt_state = I2;
        }
      }
    } else {  // I2
      if (j > 0) {
        if (getI(node, j - 1) == cur - e2) {
          bt_node = node; bt_j = j - 1; bt_state = I;
        } else if (getI2(node, j - 1) == cur - e2) {
          bt_node = node; bt_j = j - 1; bt_state = I2;
        }
      }
    }

    if (bt_node < 0) break;

    if (state == M && bt_state != M) {
      node = bt_node;
      j = bt_j;
      state = bt_state;
      continue;
    }

    if (state == M)
      pairs.push_back({node, (int32_t)(j - 1)});
    else if (state == I || state == I2)
      pairs.push_back({-1, (int32_t)(j - 1)});
    else
      pairs.push_back({node, -1});

    if (bt_node == g.start_node) break;
    node = bt_node;
    j = bt_j;
    state = bt_state;
  }

  std::reverse(pairs.begin(), pairs.end());
  if ((int64_t)pairs.size() > cap) return -2;
  int64_t count = 0;
  for (auto& [rp, qp] : pairs) {
    out_rpos[count] = rp;
    out_qpos[count] = qp;
    ++count;
  }
  return count;
}

template <typename T>
int64_t align_anchored_impl(void* ptr, const uint8_t* seq, int64_t n,
                              int32_t end_node, int64_t end_j,
                              int32_t mismatch, int32_t gap_open,
                              int32_t gap_extend, int32_t gap_extend2,
                              int32_t two_piece, int32_t free_start,
                              int64_t expected_score, int32_t* out_rpos,
                              int32_t* out_qpos, int64_t cap,
                              int64_t* out_score) {
  // End-anchored corridor alignment (one- or two-piece): the device fill
  // has already computed the read's optimal ends-free score AND its end
  // state (end_node, end_j); this fills only the sub-DAG that can reach
  // the anchor within the path-length budget D = end_j + K + 1 edges
  // (found by a bounded reverse BFS; topo-index proxies are unsound on
  // fused graphs, where a path's index span exceeds its edge count).
  // Per visited node the offset window is
  //   [end_j - maxpath(v->anchor) - K,  end_j - mindist(v->anchor) + K].
  //
  // K ladder: K_full = (S - open)/cheapest-extend bounds any single gap
  // on an <=S path, so a K_full corridor is PROVEN sufficient — but the
  // typical read's true diagonal drift is far smaller than its score
  // implies (score is mostly mismatches + many short gaps, not one long
  // one).  Attempts therefore start at K_full/16 and widen 4x; a
  // verified narrow attempt (anchor score == device score) is exact by
  // DP monotonicity — restricting the corridor can only raise scores,
  // so equality certifies an optimal in-corridor path.  Failed narrow
  // attempts cost <=1/3 extra work in the worst case (geometric sum).
  auto& eng = *static_cast<Engine*>(ptr);
  const Graph& g = eng.g;
  ensure_banded_meta(eng);
  const int32_t o = gap_open, e = gap_extend, x = mismatch;
  const int32_t e2 = gap_extend2;
  const bool tp = two_piece != 0;
  const int32_t INF = table_inf<T>();
  // same int32 INF-clamping bound as poasta_align_banded's row pass
  if (o > (1 << 20) || e > (1 << 20) || x > (1 << 20) || e2 > (1 << 20))
    return -5;
  const int64_t S = expected_score;

  std::vector<int32_t> tpos(g.n);
  for (int32_t rt = 0; rt < g.n; ++rt) tpos[eng.topo[rt]] = rt;

  for (int i = 0; i < 6; ++i) g_anchor_stats[i] = 0;
  using Clock = std::chrono::steady_clock;
  auto ns_since = [](Clock::time_point t0) {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               Clock::now() - t0)
        .count();
  };

  const int64_t cheap_e = tp ? std::min(e, e2) : e;
  const int64_t K_full = (S >= o + cheap_e) ? (S - o) / cheap_e : 0;
  std::vector<int64_t> ladder;
  for (int64_t k = std::max<int64_t>(16, K_full / 16); k < K_full; k *= 4)
    ladder.push_back(k);
  ladder.push_back(K_full);           // proven-sufficient window
  ladder.push_back(2 * K_full + 64);  // defensive (should never trigger)

  for (int attempt = 0; attempt < (int)ladder.size(); ++attempt) {
    auto t_corridor = Clock::now();
    const int64_t K = ladder[attempt];
    const int64_t D = end_j + K + 1;

    // bounded reverse BFS from the anchor over predecessor edges
    std::vector<int64_t> dist_r(g.n, -1);
    std::deque<int32_t> q;
    dist_r[end_node] = 0;
    q.push_back(end_node);
    std::vector<int32_t> nodes;  // visited, any order
    nodes.push_back(end_node);
    while (!q.empty()) {
      int32_t v = q.front();
      q.pop_front();
      if (dist_r[v] >= D) continue;
      for (int32_t p : g.preds[v])
        if (dist_r[p] < 0) {
          dist_r[p] = dist_r[v] + 1;
          nodes.push_back(p);
          q.push_back(p);
        }
    }
    std::sort(nodes.begin(), nodes.end(),
              [&](int32_t a, int32_t b) { return tpos[a] < tpos[b]; });
    const int32_t nr = (int32_t)nodes.size();

    // longest path to the anchor within the sub-DAG (upper bound on
    // query consumed after v), reverse topo order; capped at D
    std::vector<int64_t> mp(g.n, -1);
    std::vector<int32_t> lidx(g.n, -1);
    for (int32_t i = 0; i < nr; ++i) lidx[nodes[i]] = i;
    for (int32_t i = nr - 1; i >= 0; --i) {
      int32_t v = nodes[i];
      if (v == end_node) {
        mp[v] = 0;
        continue;
      }
      int64_t best = -1;
      for (int32_t s : g.succs[v])
        if (lidx[s] >= 0 && mp[s] >= 0) best = std::max(best, mp[s] + 1);
      mp[v] = best < 0 ? -1 : std::min(best, D);
    }

    std::vector<int64_t> lo(nr), hi(nr), base(nr + 1, 0);
    for (int32_t i = 0; i < nr; ++i) {
      int32_t nd = nodes[i];
      if (mp[nd] < 0) {  // cannot reach anchor (pred-only artifact)
        lo[i] = 1;
        hi[i] = 0;
      } else {
        lo[i] = std::max<int64_t>(0, end_j - mp[nd] - K);
        hi[i] = std::min<int64_t>(std::min<int64_t>(n, end_j),
                                  end_j - dist_r[nd] + K);
      }
      base[i + 1] = base[i] + std::max<int64_t>(0, hi[i] - lo[i] + 1);
    }
    const int64_t total = base[nr];
    g_anchor_stats[0] += ns_since(t_corridor);
    g_anchor_stats[3] += nr;
    g_anchor_stats[4] += total;
    g_anchor_stats[5] = attempt + 1;
    auto t_fill = Clock::now();
    RawTable<T> Mb(total), Ib(total), Db(total);
    RawTable<T> I2b(tp ? total : 0), D2b(tp ? total : 0);

    auto stored = [&](int32_t nd, int64_t j) -> bool {
      int32_t i = lidx[nd];
      return i >= 0 && j >= lo[i] && j <= hi[i];
    };
    auto gM = [&](int32_t nd, int64_t j) -> int32_t {
      return stored(nd, j) ? Mb[base[lidx[nd]] + (j - lo[lidx[nd]])] : INF;
    };
    auto gI = [&](int32_t nd, int64_t j) -> int32_t {
      return stored(nd, j) ? Ib[base[lidx[nd]] + (j - lo[lidx[nd]])] : INF;
    };
    auto gD = [&](int32_t nd, int64_t j) -> int32_t {
      return stored(nd, j) ? Db[base[lidx[nd]] + (j - lo[lidx[nd]])] : INF;
    };
    auto gI2 = [&](int32_t nd, int64_t j) -> int32_t {
      return (tp && stored(nd, j))
                 ? I2b[base[lidx[nd]] + (j - lo[lidx[nd]])]
                 : INF;
    };
    auto gD2 = [&](int32_t nd, int64_t j) -> int32_t {
      return (tp && stored(nd, j))
                 ? D2b[base[lidx[nd]] + (j - lo[lidx[nd]])]
                 : INF;
    };

    fill_rows<T>(
        g, seq, o, e, x, e2, tp, INF, nr,
        [&](int32_t i) { return nodes[i]; },
        [&](int32_t i, int32_t, int64_t& jlo, int64_t& jhi, int64_t& rb) {
          if (hi[i] < lo[i]) return false;
          jlo = lo[i];
          jhi = hi[i];
          rb = base[i];
          return true;
        },
        [&](int32_t p, int64_t& plo, int64_t& phi, int64_t& pb) {
          int32_t pi = lidx[p];
          if (pi < 0 || hi[pi] < lo[pi]) return false;
          plo = lo[pi];
          phi = hi[pi];
          pb = base[pi];
          return true;
        },
        [&](int32_t nd) {
          return (free_start && nd != g.end_node) || nd == g.start_node;
        },
        Mb, Ib, Db, I2b, D2b);

    int64_t got = gM(end_node, end_j);
    g_anchor_stats[1] += ns_since(t_fill);
    if (got != S) continue;  // corridor too tight (defensive): widen
    out_score[0] = got;
    auto t_bt = Clock::now();

    auto preds_oldest = [&](int32_t nd) {
      return std::vector<int32_t>(g.preds[nd].rbegin(), g.preds[nd].rend());
    };
    int32_t node = end_node;
    int64_t j = end_j;
    int state = M;
    if (node == g.end_node) {  // virtual end: hop to the carrying pred
      int32_t nn = -1;
      for (int32_t p : preds_oldest(g.end_node))
        if (gM(p, j) == got) {
          nn = p;
          break;
        }
      if (nn < 0) return -3;
      node = nn;
    }
    std::vector<std::pair<int32_t, int32_t>> pairs;
    while (true) {
      int32_t cur = state == M    ? gM(node, j)
                    : state == D  ? gD(node, j)
                    : state == I  ? gI(node, j)
                    : state == D2 ? gD2(node, j)
                                  : gI2(node, j);
      bool origin_nd =
          (free_start && node != g.end_node) || node == g.start_node;
      if (state == M && j == 0 && cur == 0 && origin_nd) break;
      int32_t bt_node = -1;
      int64_t bt_j = 0;
      int bt_state = M;
      if (state == M) {
        if (j > 0) {
          int32_t want = g.symbol_equal(node, seq[j - 1]) ? cur : cur - x;
          for (int32_t p : preds_oldest(node))
            if (gM(p, j - 1) == want) {
              bt_node = p;
              bt_j = j - 1;
              bt_state = M;
              break;
            }
        }
        if (bt_node < 0 && gD(node, j) == cur) {
          bt_node = node; bt_j = j; bt_state = D;
        }
        if (tp && bt_node < 0 && gD2(node, j) == cur) {
          bt_node = node; bt_j = j; bt_state = D2;
        }
        if (bt_node < 0 && gI(node, j) == cur) {
          bt_node = node; bt_j = j; bt_state = I;
        }
        if (tp && bt_node < 0 && gI2(node, j) == cur) {
          bt_node = node; bt_j = j; bt_state = I2;
        }
      } else if (state == D) {
        for (int32_t p : preds_oldest(node))
          if (gM(p, j) == cur - o - e) {
            bt_node = p; bt_j = j; bt_state = M;
            break;
          }
        if (bt_node < 0)
          for (int32_t p : preds_oldest(node))
            if (gD(p, j) == cur - e) {
              bt_node = p; bt_j = j; bt_state = D;
              break;
            }
      } else if (state == D2) {
        for (int32_t p : preds_oldest(node))
          if (gD(p, j) == cur - e2) {
            bt_node = p; bt_j = j; bt_state = D;
            break;
          }
        if (bt_node < 0)
          for (int32_t p : preds_oldest(node))
            if (gD2(p, j) == cur - e2) {
              bt_node = p; bt_j = j; bt_state = D2;
              break;
            }
      } else if (state == I) {
        if (j > 0) {
          if (gM(node, j - 1) == cur - o - e) {
            bt_node = node; bt_j = j - 1; bt_state = M;
          } else if (gI(node, j - 1) == cur - e) {
            bt_node = node; bt_j = j - 1; bt_state = I;
          } else if (tp && gI2(node, j - 1) == cur - o - e) {
            bt_node = node; bt_j = j - 1; bt_state = I2;
          }
        }
      } else {  // I2
        if (j > 0) {
          if (gI(node, j - 1) == cur - e2) {
            bt_node = node; bt_j = j - 1; bt_state = I;
          } else if (gI2(node, j - 1) == cur - e2) {
            bt_node = node; bt_j = j - 1; bt_state = I2;
          }
        }
      }
      if (bt_node < 0) break;
      if (state == M && bt_state != M) {
        node = bt_node;
        j = bt_j;
        state = bt_state;
        continue;
      }
      if (state == M)
        pairs.push_back({node, (int32_t)(j - 1)});
      else if (state == I || state == I2)
        pairs.push_back({-1, (int32_t)(j - 1)});
      else
        pairs.push_back({node, -1});
      if (bt_node == g.start_node) break;
      node = bt_node;
      j = bt_j;
      state = bt_state;
    }
    std::reverse(pairs.begin(), pairs.end());
    if ((int64_t)pairs.size() > cap) return -2;
    int64_t count = 0;
    for (auto& [rp, qp] : pairs) {
      out_rpos[count] = rp;
      out_qpos[count] = qp;
      ++count;
    }
    g_anchor_stats[2] += ns_since(t_bt);
    return count;
  }
  return -4;  // corridor never verified: caller falls back
}

}  // namespace

extern "C" {

// Bump whenever any extern "C" signature or export changes.  The Python
// loader refuses binaries whose version differs, so a stale shipped
// portable build can never be called through the wrong ABI (mtimes are
// useless after a fresh clone — every file gets the checkout time).
int32_t poasta_abi_version(void) { return 3; }

void* poasta_engine_create(int32_t n_nodes, const uint8_t* symbols,
                           const int32_t* succ_ptr, const int32_t* succ_idx,
                           const int32_t* pred_ptr, const int32_t* pred_idx,
                           int32_t start_node, int32_t end_node) {
  auto* eng = new Engine();
  eng->g.n = n_nodes;
  eng->g.start_node = start_node;
  eng->g.end_node = end_node;
  // copy symbols so python can free its buffer
  static_assert(sizeof(uint8_t) == 1, "");
  uint8_t* sym = new uint8_t[n_nodes];
  std::memcpy(sym, symbols, n_nodes);
  eng->g.symbols = sym;
  eng->g.succs.assign(n_nodes, {});
  eng->g.preds.assign(n_nodes, {});
  for (int32_t v = 0; v < n_nodes; ++v) {
    eng->g.succs[v].assign(succ_idx + succ_ptr[v], succ_idx + succ_ptr[v + 1]);
    eng->g.preds[v].assign(pred_idx + pred_ptr[v], pred_idx + pred_ptr[v + 1]);
  }
  eng->bi = build_bubble_index(eng->g);
  return eng;
}

void poasta_engine_destroy(void* ptr) {
  auto* eng = static_cast<Engine*>(ptr);
  delete[] eng->g.symbols;
  delete eng;
}

// Returns the number of alignment pairs written (or -1 on failure).
// out_rpos/out_qpos have capacity cap; -1 encodes "None".
int64_t poasta_align(void* ptr, const uint8_t* seq, int64_t seq_len,
                     int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                     int32_t gap_open2, int32_t gap_extend2, int32_t two_piece,
                     int32_t heuristic, int32_t enable_pruning,
                     int32_t* out_rpos, int32_t* out_qpos, int64_t cap,
                     int64_t* out_score, int64_t* out_stats) {
  auto& eng = *static_cast<Engine*>(ptr);
  const Graph& g = eng.g;
  AlignParams p;
  p.costs = {mismatch, gap_open, gap_extend, gap_open2, gap_extend2,
             two_piece != 0};
  p.heuristic = heuristic;
  const Costs& c = p.costs;

  Visited v;
  v.g = &g;
  v.bi = &eng.bi;
  v.c = &c;
  v.seq_len = seq_len;
  v.reached.assign(g.n, {});

  BucketQueue queue;
  queue.two_piece = c.two_piece;
  int64_t num_queued = 0, num_visited = 0, num_pruned = 0;

  auto h_of = [&](int32_t node, int32_t off, int st) {
    return heuristic_h(eng, p, node, off, st, seq_len);
  };
  auto emit = [&](int32_t delta, int32_t node, int32_t off, int st,
                  int32_t base) {
    ++num_queued;
    queue.push(node, off, st, base + delta, h_of(node, off, st));
  };

  // initial state: global alignment from the virtual start node
  queue.push(g.start_node, 0, M, 0, h_of(g.start_node, 0, M));
  v.set(g.start_node, 0, M, 0);
  ++num_queued;

  int32_t end_score = -1, end_node = -1, end_off = -1;

  auto expand_match = [&](int32_t score, int32_t node, int32_t off) {
    int32_t child_off = off + 1;
    for (int32_t succ : g.succs[node]) {
      if (succ == g.end_node) continue;
      if (child_off <= seq_len) {
        int32_t delta =
            g.symbol_equal(succ, seq[child_off - 1]) ? 0 : c.mismatch;
        if (v.update_if_lower(succ, child_off, M, score + delta))
          emit(delta, succ, child_off, M, score);
      }
      int32_t delta = c.gap_open + c.gap_extend;
      if (v.update_if_lower(succ, off, D, score + delta))
        emit(delta, succ, off, D, score);
    }
    int32_t delta = c.gap_open + c.gap_extend;
    if (child_off <= seq_len &&
        v.update_if_lower(node, child_off, I, score + delta))
      emit(delta, node, child_off, I, score);
  };

  auto expand_mismatch = [&](int32_t score, int32_t pnode, int32_t poff,
                             int32_t cnode, int32_t coff) {
    if (v.update_if_lower(cnode, coff, M, score + c.mismatch))
      emit(c.mismatch, cnode, coff, M, score);
    int32_t delta = c.gap_open + c.gap_extend;
    if (v.update_if_lower(pnode, poff + 1, I, score + delta))
      emit(delta, pnode, poff + 1, I, score);
    if (v.update_if_lower(cnode, poff, D, score + delta))
      emit(delta, cnode, poff, D, score);
  };

  while (end_node < 0) {
    QueueItem item;
    int st;
    if (!queue.pop(&item, &st)) return -1;  // empty queue: cannot align
    int32_t score = item.score, node = item.node, off = item.offset;

    int32_t stored = v.get(node, off, st);
    if (stored != kUnvisited && score > stored) continue;

    if (st == M && node == g.end_node && off == seq_len) {
      ++num_visited;
      end_score = score;
      end_node = node;
      end_off = off;
      break;
    }

    if (enable_pruning && st == M && v.prune(node, off, st, score)) {
      ++num_pruned;
      continue;
    }

    v.mark_reached(node, off, st);
    ++num_visited;

    if (st == M) {
      expand_match(score, node, off);

      // depth-first greedy match extension
      struct Frame {
        int32_t node, off;
        size_t idx;
      };
      std::vector<Frame> stack;
      stack.push_back({node, off, 0});
      int64_t dfa_visited = 0;
      bool stop = false;

      // initial offset-0 self-match special case
      if (seq_len > 0 && off == 0 && g.symbol_equal(node, seq[0])) {
        if (v.update_if_lower(node, 1, M, score)) {
          stack.back() = {node, 1, 0};
          v.mark_reached(node, 1, M);
          ++dfa_visited;
          if (seq_len == 1) {
            // whole query consumed at the initial node
            if (node == g.end_node) { /* unreachable for start node */
            }
          }
        }
      }

      while (!stack.empty() && !stop) {
        Frame& top = stack.back();
        const auto& succ = g.succs[top.node];
        bool advanced = false;
        while (top.idx < succ.size()) {
          int32_t child = succ[top.idx++];
          if (child == g.end_node) {
            v.update_if_lower(child, top.off, M, score);
            if (top.off == seq_len) {
              end_score = score;
              end_node = child;
              end_off = top.off;
              stop = true;
            } else {
              // expand_ref_graph_end: open insertion from the parent
              int32_t delta = c.gap_open + c.gap_extend;
              if (v.update_if_lower(top.node, top.off + 1, I, score + delta))
                emit(delta, top.node, top.off + 1, I, score);
            }
            break;
          }
          if (top.off >= seq_len) {
            // expand_query_end: open deletion onto the child
            int32_t delta = c.gap_open + c.gap_extend;
            if (v.update_if_lower(child, top.off, D, score + delta))
              emit(delta, child, top.off, D, score);
            break;
          }
          int32_t child_off = top.off + 1;
          if (g.symbol_equal(child, seq[child_off - 1])) {
            if (v.update_if_lower(child, child_off, M, score)) {
              if (v.prune(child, child_off, M, score)) {
                ++num_pruned;
                continue;
              }
              v.mark_reached(child, child_off, M);
              ++dfa_visited;
              stack.push_back({child, child_off, 0});
              advanced = true;
              break;
            }
          } else {
            expand_mismatch(score, top.node, top.off, child, child_off);
            break;
          }
        }
        if (stop) break;
        if (!advanced && stack.back().idx >= g.succs[stack.back().node].size())
          stack.pop_back();
      }
      if (stop) {
        // breaking pop doesn't fold DFA-visited counts (parity with engine.py)
        break;
      }
      num_visited += dfa_visited;
    } else if (st == I) {
      if (v.update_if_lower(node, off, M, score)) emit(0, node, off, M, score);
      if (off < seq_len) {
        if (v.update_if_lower(node, off + 1, I, score + c.gap_extend))
          emit(c.gap_extend, node, off + 1, I, score);
        if (c.two_piece &&
            v.update_if_lower(node, off + 1, I2, score + c.gap_extend2))
          emit(c.gap_extend2, node, off + 1, I2, score);
      }
    } else if (st == I2) {
      if (v.update_if_lower(node, off, M, score)) emit(0, node, off, M, score);
      if (off < seq_len &&
          v.update_if_lower(node, off + 1, I2, score + c.gap_extend2))
        emit(c.gap_extend2, node, off + 1, I2, score);
    } else if (st == D) {
      if (v.update_if_lower(node, off, M, score)) emit(0, node, off, M, score);
      for (int32_t succ : g.succs[node]) {
        if (v.update_if_lower(succ, off, D, score + c.gap_extend))
          emit(c.gap_extend, succ, off, D, score);
        if (c.two_piece &&
            v.update_if_lower(succ, off, D2, score + c.gap_extend2))
          emit(c.gap_extend2, succ, off, D2, score);
      }
    } else {  // D2
      if (v.update_if_lower(node, off, M, score)) emit(0, node, off, M, score);
      for (int32_t succ : g.succs[node])
        if (v.update_if_lower(succ, off, D2, score + c.gap_extend2))
          emit(c.gap_extend2, succ, off, D2, score);
    }
  }

  out_score[0] = end_score;
  out_stats[0] = num_queued;
  out_stats[1] = num_visited;
  out_stats[2] = num_pruned;

  // ---------------- backtrace ----------------
  if (seq_len == 0) return 0;

  int64_t count = 0;
  // NB: no 1-char shortcut — the end node "matches" every symbol, so
  // anchoring a pair at it would leak the virtual end node into the
  // alignment and corrupt graph fusion (python engine agrees).

  // find the first step from the end state over M, I, I2, D, D2
  BtStep start{0, 0, 0, false};
  int states_single[3] = {M, I, D};
  int states_two[5] = {M, I, I2, D, D2};
  int* states = c.two_piece ? states_two : states_single;
  int n_states = c.two_piece ? 5 : 3;
  for (int i = 0; i < n_states && !start.ok; ++i)
    start = backtrace_step(eng, v, c, seq, seq_len, end_node, end_off, states[i]);
  if (!start.ok) return -3;

  int32_t rn = start.node, ro = start.offset;
  int rs = start.state;
  std::vector<std::pair<int32_t, int32_t>> pairs;

  while (true) {
    BtStep bt = backtrace_step(eng, v, c, seq, seq_len, rn, ro, rs);
    if (!bt.ok) break;
    if (rs == M && bt.state != M) {  // zero-cost indel closure
      rn = bt.node;
      ro = bt.offset;
      rs = bt.state;
      continue;
    }
    if (rs == M) {
      pairs.push_back({rn, ro - 1});
    } else if (rs == I || rs == I2) {
      pairs.push_back({-1, ro - 1});
    } else {
      pairs.push_back({rn, -1});
    }
    if (bt.node == g.start_node) break;
    rn = bt.node;
    ro = bt.offset;
    rs = bt.state;
  }

  std::reverse(pairs.begin(), pairs.end());
  if ((int64_t)pairs.size() > cap) return -2;
  for (auto& [r, q] : pairs) {
    out_rpos[count] = r;
    out_qpos[count] = q;
    ++count;
  }
  return count;
}

// Banded dense fill + score-difference backtrace (gap-affine, global;
// one- or two-piece).
//
// Windows per node mirror poasta_tpu/aligner/banded.py band_windows; the
// fill mirrors ops/dp_rows.py / dp_rows_2p.py row semantics; the backtrace
// mirrors wavefront.py backtrace_dense (same priority rules, so the
// emitted co-optimal alignment matches the wavefront engine's).  Exact
// when the returned score <= ub: every cell of any <=ub path lies inside
// the band (banded.py docstring) — callers retry with a larger ub
// otherwise.
//
// Returns pair count; -2 if cap exceeded; -4 if the score exceeds ub
// (out_score still holds the banded score, an upper bound on the truth).
int64_t poasta_align_banded(void* ptr, const uint8_t* seq, int64_t n,
                            int32_t mismatch, int32_t gap_open,
                            int32_t gap_extend, int32_t gap_extend2,
                            int32_t two_piece, int64_t ub,
                            int32_t* out_rpos, int32_t* out_qpos, int64_t cap,
                            int64_t* out_score) {
  // int16 tables halve the DP-table memory traffic (the bottleneck at
  // fusion shapes).  Sound whenever ub sits below the int16 INF:
  // every cell the result or backtrace depends on holds a value
  // <= ub < 32767 and is stored exactly; saturated cells only
  // over-estimate, exactly like out-of-band cells.
  if (ub <= 30000) {
    int64_t rc = align_banded_impl<int16_t>(ptr, seq, n, mismatch, gap_open,
                                            gap_extend, gap_extend2,
                                            two_piece, ub, out_rpos,
                                            out_qpos, cap, out_score);
    // A failed (-4) int16 attempt whose score hit the clamp is NOT a
    // true upper bound on the banded score (the int32 invariant the
    // retry ladder leans on); report the no-usable-bound sentinel so
    // the caller's ladder keeps doubling instead of pinning ub at the
    // saturated value below the truth.
    if (rc == -4 && out_score[0] >= 32767) out_score[0] = (int64_t)1 << 28;
    return rc;
  }
  return align_banded_impl<int32_t>(ptr, seq, n, mismatch, gap_open,
                                    gap_extend, gap_extend2, two_piece, ub,
                                    out_rpos, out_qpos, cap, out_score);
}

void poasta_last_anchored_stats(int64_t* out6) {
  for (int i = 0; i < 6; ++i) out6[i] = g_anchor_stats[i];
}

int64_t poasta_align_anchored(void* ptr, const uint8_t* seq, int64_t n,
                              int32_t end_node, int64_t end_j,
                              int32_t mismatch, int32_t gap_open,
                              int32_t gap_extend, int32_t gap_extend2,
                              int32_t two_piece, int32_t free_start,
                              int64_t expected_score, int32_t* out_rpos,
                              int32_t* out_qpos, int64_t cap,
                              int64_t* out_score) {
  // same int16 gate as poasta_align_banded: the device-certified score
  // bounds every value the certificate and backtrace depend on
  if (expected_score <= 30000)
    return align_anchored_impl<int16_t>(
        ptr, seq, n, end_node, end_j, mismatch, gap_open, gap_extend,
        gap_extend2, two_piece, free_start, expected_score, out_rpos,
        out_qpos, cap, out_score);
  return align_anchored_impl<int32_t>(
      ptr, seq, n, end_node, end_j, mismatch, gap_open, gap_extend,
      gap_extend2, two_piece, free_start, expected_score, out_rpos,
      out_qpos, cap, out_score);
}

}  // extern "C"
