// compilecore — native graph-compile inner loops.
//
// The graph compiler (numbskull_jax/compile.py) lowers a factor graph to
// per-color work-item tables: the deduplicated (factor, variable, slot)
// attachment relation of the reference's compute_var_map (reference:
// numbskull/dataloading.py:16-81), folded to (factor, variable) items
// with <=2 slot values, grouped by variable color and sorted by target
// row. The numpy pipeline expresses this as ~30 full-array passes
// (lexsort, gathers, scatters); at 10M+ variables that is minutes of
// memory traffic. This core does the same job as two sequential passes
// (count, fill) with per-factor working sets, exposed via ctypes.
// compile.py keeps the numpy pipeline as the fallback and as the test
// oracle (tests/test_native.py asserts exact plan equality).
//
// Also hosts dump_rows: fixed-point text formatting for the DimmWitted
// output files (reference: numbskull/factorgraph.py:210-229), because
// every numpy text conversion is a per-element sprintf.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <ctime>
#include <memory>
#include <new>
#include <vector>

namespace {

constexpr int64_t kMaxArity = 4096;

struct Pair {
  int64_t v;
  int64_t slot;
};

// Strided field view into a numpy structured array (no astype copies on
// the Python side — the factor/fmap/variable records are read in place).
struct Field {
  const uint8_t* base;
  int64_t stride;
  int64_t i64(int64_t i) const {
    int64_t v;
    std::memcpy(&v, base + i * stride, 8);
    return v;
  }
  int16_t i16(int64_t i) const {
    int16_t v;
    std::memcpy(&v, base + i * stride, 2);
    return v;
  }
  double f64(int64_t i) const {
    double v;
    std::memcpy(&v, base + i * stride, 8);
    return v;
  }
};

struct Graph {
  Field ffunc, fwid, ffv, farity, fftv;  // factor fields
  Field mvid, meq;                       // fmap fields
  Field vdtype, vcard;                   // variable fields
};

// Gathers factor f's deduplicated (variable, slot) pairs sorted by
// (v, slot); returns count, or -1 if arity exceeds the working buffer.
inline int64_t factor_pairs(const Graph& g, int64_t a0, int64_t a,
                            Pair* buf, const uint8_t* dtype8 = nullptr) {
  if (a > kMaxArity) return -1;
  for (int64_t j = 0; j < a; ++j) {
    int64_t v = g.mvid.i64(a0 + j);
    buf[j].v = v;
    int bool_var = dtype8 ? dtype8[v] == 0 : g.vdtype.i16(v) == 0;
    buf[j].slot = bool_var ? 0 : g.meq.i64(a0 + j);
  }
  std::sort(buf, buf + a, [](const Pair& x, const Pair& y) {
    return x.v < y.v || (x.v == y.v && x.slot < y.slot);
  });
  int64_t m = 0;
  for (int64_t j = 0; j < a; ++j) {
    if (j == 0 || buf[j].v != buf[m - 1].v || buf[j].slot != buf[m - 1].slot)
      buf[m++] = buf[j];
  }
  return m;
}

Graph make_graph(const uint8_t* fac, int64_t fac_stride, const int64_t* foff,
                 const uint8_t* fmp, int64_t fmp_stride, const int64_t* moff,
                 const uint8_t* var, int64_t var_stride,
                 const int64_t* voff) {
  Graph g;
  g.ffunc = {fac + foff[0], fac_stride};
  g.fwid = {fac + foff[1], fac_stride};
  g.ffv = {fac + foff[2], fac_stride};
  g.farity = {fac + foff[3], fac_stride};
  g.fftv = {fac + foff[4], fac_stride};
  g.mvid = {fmp + moff[0], fmp_stride};
  g.meq = {fmp + moff[1], fmp_stride};
  g.vdtype = {var + voff[0], var_stride};
  g.vcard = {var + voff[1], var_stride};
  return g;
}

inline double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

// Dense per-variable working tables: the structured Variable records
// are 27-byte strided, so per-item random reads of dataType/cardinality
// each touch a ~250 MB region at 10M vars; one sequential pass shrinks
// the hot randomly-read state to dtype 1 B + card 4 B per variable.
struct VarDense {
  std::unique_ptr<uint8_t[]> dtype8;
  std::unique_ptr<int32_t[]> card32;
};

inline bool densify_vars(const Graph& g, int64_t V, VarDense* out) {
  out->dtype8.reset(new (std::nothrow) uint8_t[V > 0 ? V : 1]);
  out->card32.reset(new (std::nothrow) int32_t[V > 0 ? V : 1]);
  if (!out->dtype8 || !out->card32) return false;
  for (int64_t v = 0; v < V; ++v) {
    out->dtype8[v] = g.vdtype.i16(v) == 0 ? 0 : 1;
    int64_t c = g.vcard.i64(v);
    out->card32[v] = c > INT32_MAX ? INT32_MAX : static_cast<int32_t>(c);
  }
  return true;
}

}  // namespace

extern "C" {

// Pass 1: count items per global row (rowcount must be zeroed by the
// caller) and the max arity among kept factors. Returns the total item
// count, or -1 when a factor exceeds the arity working buffer.
// Structured-array fields are read in place via (base, stride, offsets):
// foff = {factorFunction, weightId, featureValue, arity, ftv_offset},
// moff = {vid, dense_equal_to}, voff = {dataType, cardinality}.
int64_t compile_count(int64_t F, const uint8_t* fac, int64_t fac_stride,
                      const int64_t* foff, const uint8_t* fmp,
                      int64_t fmp_stride, const int64_t* moff,
                      const uint8_t* var, int64_t var_stride,
                      const int64_t* voff, const uint8_t* skip,
                      const int64_t* grow, int64_t* rowcount,
                      int64_t* amax_out) {
  Graph g = make_graph(fac, fac_stride, foff, fmp, fmp_stride, moff, var,
                       var_stride, voff);
  Pair buf[kMaxArity];
  int64_t total = 0;
  int64_t amax = 1;
  for (int64_t f = 0; f < F; ++f) {
    if (skip[f]) continue;
    int64_t a = g.farity.i64(f);
    int64_t m = factor_pairs(g, g.fftv.i64(f), a, buf);
    if (m < 0) return -1;
    if (a > amax) amax = a;
    for (int64_t j = 0; j < m;) {
      int64_t v = buf[j].v;
      int64_t k = j;
      while (k < m && buf[k].v == v) ++k;
      int64_t items = (k - j + 1) / 2;
      rowcount[grow[v]] += items;
      total += items;
      j = k;
    }
  }
  *amax_out = amax;
  return total;
}

// Pass 2: fill the item tables. ``rowpos`` holds, per global row, the
// output index of that row's next item (exclusive prefix sums of
// rowcount, offset per color by the caller so each color's items land
// in its own padded arena region); it is consumed/advanced in place.
// Item order per row matches the numpy pipeline: ascending factor id,
// then ascending (variable, slot). Returns 0, or -1 when a weight id
// or slot value does not fit the int32 device tables.
int compile_fill(int64_t F, const uint8_t* fac, int64_t fac_stride,
                 const int64_t* foff, const uint8_t* fmp,
                 int64_t fmp_stride, const int64_t* moff,
                 const uint8_t* var, int64_t var_stride,
                 const int64_t* voff, const uint8_t* skip,
                 const int64_t* grow, const int32_t* row_in_color,
                 int64_t* rowpos, int64_t amax,
                 int32_t* it_row, int32_t* it_ftype, int32_t* it_wid,
                 float* it_fv, uint8_t* it_dense, int32_t* it_d1,
                 int32_t* it_d2, uint8_t* it_valid, int32_t* it_arity,
                 int32_t* ag_vid, int32_t* ag_eq, uint8_t* ag_valid,
                 int32_t* ag_card, uint8_t* ag_subst) {
  Graph g = make_graph(fac, fac_stride, foff, fmp, fmp_stride, moff, var,
                       var_stride, voff);
  Pair buf[kMaxArity];
  for (int64_t f = 0; f < F; ++f) {
    if (skip[f]) continue;
    int64_t a0 = g.fftv.i64(f);
    int64_t a = g.farity.i64(f);
    int64_t m = factor_pairs(g, a0, a, buf);
    if (m < 0) return -1;
    int64_t wid = g.fwid.i64(f);
    if (wid < 0 || wid > INT32_MAX) return -1;
    int16_t func = g.ffunc.i16(f);
    float fv = static_cast<float>(g.ffv.f64(f));
    for (int64_t j = 0; j < m;) {
      int64_t v = buf[j].v;
      int64_t k = j;
      while (k < m && buf[k].v == v) ++k;
      for (int64_t s = j; s < k; s += 2) {
        int64_t d1 = buf[s].slot;
        int64_t d2 = (s + 1 < k) ? buf[s + 1].slot : d1;
        if (d1 < INT32_MIN || d1 > INT32_MAX || d2 > INT32_MAX) return -1;
        int64_t i = rowpos[grow[v]]++;
        it_row[i] = row_in_color[v];
        it_ftype[i] = func;
        it_wid[i] = static_cast<int32_t>(wid);
        it_fv[i] = fv;
        it_dense[i] = g.vdtype.i16(v) == 0 ? 1 : 0;
        it_d1[i] = static_cast<int32_t>(d1);
        it_d2[i] = static_cast<int32_t>(d2);
        it_valid[i] = 1;
        it_arity[i] = static_cast<int32_t>(a);
        int64_t base = i * amax;
        for (int64_t t = 0; t < amax; ++t) {
          if (t < a) {
            int64_t av = g.mvid.i64(a0 + t);
            int64_t eq = g.meq.i64(a0 + t);
            if (eq < INT32_MIN || eq > INT32_MAX) return -1;
            ag_vid[base + t] = static_cast<int32_t>(av);
            ag_eq[base + t] = static_cast<int32_t>(eq);
            ag_valid[base + t] = 1;
            ag_card[base + t] = static_cast<int32_t>(g.vcard.i64(av));
            ag_subst[base + t] = av == v ? 1 : 0;
          } else {
            ag_vid[base + t] = 0;
            ag_eq[base + t] = 0;
            ag_valid[base + t] = 0;
            ag_card[base + t] = 1;
            ag_subst[base + t] = 0;
          }
        }
      }
      j = k;
    }
  }
  return 0;
}

// compile_count with dense per-variable tables: identical output, but
// the per-item random reads/rmws touch dtype 1 B + a V-sized i64
// counter instead of the 27 B-strided Variable records and the
// row-indexed count array.
int64_t compile_count2(int64_t F, int64_t V, const uint8_t* fac,
                       int64_t fac_stride, const int64_t* foff,
                       const uint8_t* fmp, int64_t fmp_stride,
                       const int64_t* moff, const uint8_t* var,
                       int64_t var_stride, const int64_t* voff,
                       const uint8_t* skip, const int64_t* grow,
                       int64_t* rowcount, int64_t* amax_out) {
  Graph g = make_graph(fac, fac_stride, foff, fmp, fmp_stride, moff, var,
                       var_stride, voff);
  VarDense dv;
  if (!densify_vars(g, V, &dv)) return -1;
  std::vector<int64_t> rc(static_cast<size_t>(V > 0 ? V : 1), 0);
  Pair buf[kMaxArity];
  int64_t total = 0;
  int64_t amax = 1;
  for (int64_t f = 0; f < F; ++f) {
    if (skip[f]) continue;
    int64_t a = g.farity.i64(f);
    int64_t m = factor_pairs(g, g.fftv.i64(f), a, buf, dv.dtype8.get());
    if (m < 0) return -1;
    if (a > amax) amax = a;
    for (int64_t j = 0; j < m;) {
      int64_t v = buf[j].v;
      int64_t k = j;
      while (k < m && buf[k].v == v) ++k;
      int64_t items = (k - j + 1) / 2;
      rc[v] += items;
      total += items;
      j = k;
    }
  }
  for (int64_t v = 0; v < V; ++v)
    if (rc[v]) rowcount[grow[v]] += rc[v];
  *amax_out = amax;
  return total;
}

// The fast fill path. Relative to compile_fill (the simple 14-stream
// baseline above): items stage as packed AoS records appended to their
// target bucket's sequential run, then each ~96 MB bucket replays as an
// L3-local scatter followed by a fully sequential SoA split; the
// per-item random state collapses to one 16-byte record
// {cursor:i64, row:i32, dtype:u8} per variable plus a dense i32
// cardinality array for the per-arg lookups. Output is byte-identical
// to compile_fill.
int compile_fill3(int64_t F, int64_t V, const uint8_t* fac,
                  int64_t fac_stride, const int64_t* foff,
                  const uint8_t* fmp, int64_t fmp_stride,
                  const int64_t* moff, const uint8_t* var,
                  int64_t var_stride, const int64_t* voff,
                  const uint8_t* skip, const int64_t* grow,
                  const int32_t* row_in_color, const int64_t* rowpos,
                  int64_t amax, int64_t arena_total,
                  int32_t* it_row, int32_t* it_ftype, int32_t* it_wid,
                  float* it_fv, uint8_t* it_dense, int32_t* it_d1,
                  int32_t* it_d2, uint8_t* it_valid, int32_t* it_arity,
                  int32_t* ag_vid, int32_t* ag_eq, uint8_t* ag_valid,
                  int32_t* ag_card, uint8_t* ag_subst) {
  Graph g = make_graph(fac, fac_stride, foff, fmp, fmp_stride, moff, var,
                       var_stride, voff);
  VarDense dv;
  if (!densify_vars(g, V, &dv)) return -1;
  struct PV { int64_t pos; int32_t ric; uint8_t dtype; uint8_t pad[3]; };
  std::unique_ptr<PV[]> pv(new (std::nothrow) PV[V > 0 ? V : 1]);
  if (!pv) return -1;
  for (int64_t v = 0; v < V; ++v)
    pv[v] = PV{rowpos[grow[v]], row_in_color[v], dv.dtype8[v], {0, 0, 0}};
  const int32_t* card32 = dv.card32.get();
  const uint8_t* dtype8 = dv.dtype8.get();

  const int64_t rec = (32 + 14 * amax + 7) & ~int64_t(7);
  const int64_t sr = 8 + rec;
  // bucket bytes overridable so tests can exercise the multi-bucket
  // path on small graphs (NSX_FILL_BUCKET_BYTES)
  int64_t bucket_bytes = 96LL << 20;
  if (const char* bb = std::getenv("NSX_FILL_BUCKET_BYTES")) {
    int64_t val = std::atoll(bb);
    if (val > 0) bucket_bytes = val;
  }
  int64_t bs = bucket_bytes / rec;
  if (bs < 1) bs = 1;
  if (bs > arena_total) bs = arena_total > 0 ? arena_total : 1;
  const int64_t B = (arena_total + bs - 1) / bs > 0
                        ? (arena_total + bs - 1) / bs : 1;
  std::unique_ptr<uint8_t[]> stage(
      new (std::nothrow) uint8_t[static_cast<size_t>(sr) * bs * B]);
  std::unique_ptr<uint8_t[]> work(
      new (std::nothrow) uint8_t[static_cast<size_t>(rec) * bs]);
  std::vector<int64_t> scount(static_cast<size_t>(B), 0);
  if (!stage || !work) return -1;
  const bool dbg = std::getenv("NSX_FILL_DEBUG") != nullptr;
  double tA = now_s();
  uint8_t* S = stage.get();
  Pair buf[kMaxArity];
  for (int64_t f = 0; f < F; ++f) {
    if (skip[f]) continue;
    int64_t a0 = g.fftv.i64(f);
    int64_t a = g.farity.i64(f);
    int64_t m = factor_pairs(g, a0, a, buf, dtype8);
    if (m < 0) return -1;
    int64_t wid = g.fwid.i64(f);
    if (wid < 0 || wid > INT32_MAX) return -1;
    int32_t func = g.ffunc.i16(f);
    float fv = static_cast<float>(g.ffv.f64(f));
    int32_t a32 = static_cast<int32_t>(a);
    uint8_t argbuf[14 * kMaxArity];
    {
      int32_t* ai = reinterpret_cast<int32_t*>(argbuf);
      uint8_t* au = argbuf + 12 * amax;
      for (int64_t t = 0; t < amax; ++t) {
        if (t < a) {
          int64_t av = g.mvid.i64(a0 + t);
          int64_t eq = g.meq.i64(a0 + t);
          if (eq < INT32_MIN || eq > INT32_MAX) return -1;
          ai[3 * t] = static_cast<int32_t>(av);
          ai[3 * t + 1] = static_cast<int32_t>(eq);
          ai[3 * t + 2] = card32[av];
          au[2 * t] = 1;
          au[2 * t + 1] = 0;
        } else {
          ai[3 * t] = 0;
          ai[3 * t + 1] = 0;
          ai[3 * t + 2] = 1;
          au[2 * t] = 0;
          au[2 * t + 1] = 0;
        }
      }
    }
    for (int64_t j = 0; j < m;) {
      int64_t v = buf[j].v;
      int64_t k = j;
      while (k < m && buf[k].v == v) ++k;
      PV& p = pv[v];
      for (int64_t s = j; s < k; s += 2) {
        int64_t d1 = buf[s].slot;
        int64_t d2 = (s + 1 < k) ? buf[s + 1].slot : d1;
        if (d1 < INT32_MIN || d1 > INT32_MAX || d2 > INT32_MAX) return -1;
        int64_t i = p.pos++;
        if (i < 0 || i >= arena_total) return -1;
        const int64_t bkt = i / bs;
        const uint32_t local = static_cast<uint32_t>(i - bkt * bs);
        uint8_t* r = S + (bkt * bs + scount[bkt]++) * sr;
        std::memcpy(r, &local, 4);
        r += 8;
        int32_t head[8] = {p.ric, func, static_cast<int32_t>(wid), 0,
                           static_cast<int32_t>(d1),
                           static_cast<int32_t>(d2), a32, 0};
        std::memcpy(head + 3, &fv, 4);
        head[7] = (p.dtype == 0 ? 1 : 0) | 0x100;  // dense|valid
        std::memcpy(r, head, 32);
        std::memcpy(r + 32, argbuf, 14 * amax);
        uint8_t* au = r + 32 + 12 * amax;
        const int32_t* ai = reinterpret_cast<const int32_t*>(r + 32);
        for (int64_t t = 0; t < a; ++t)
          au[2 * t + 1] = ai[3 * t] == v ? 1 : 0;
      }
      j = k;
    }
  }
  if (dbg) std::fprintf(stderr, "fill3 phaseA %.1fs\n", now_s() - tA);
  double tB = now_s();
  uint8_t* W = work.get();
  for (int64_t b = 0; b < B; ++b) {
    const uint8_t* sb = S + b * bs * sr;
    const int64_t nb = scount[b];
    for (int64_t q = 0; q < nb; ++q) {
      uint32_t local;
      std::memcpy(&local, sb + q * sr, 4);
      std::memcpy(W + static_cast<int64_t>(local) * rec, sb + q * sr + 8,
                  rec);
    }
    const int64_t g0 = b * bs;
    const int64_t gn = (arena_total - g0 < bs) ? arena_total - g0 : bs;
    for (int64_t x = 0; x < gn; ++x) {
      const int64_t i = g0 + x;
      const uint8_t* r = W + x * rec;
      int32_t head[8];
      std::memcpy(head, r, 32);
      it_row[i] = head[0];
      it_ftype[i] = head[1];
      it_wid[i] = head[2];
      std::memcpy(it_fv + i, head + 3, 4);
      it_d1[i] = head[4];
      it_d2[i] = head[5];
      it_arity[i] = head[6];
      it_dense[i] = head[7] & 0xff;
      it_valid[i] = (head[7] >> 8) & 0xff;
      const int32_t* ai = reinterpret_cast<const int32_t*>(r + 32);
      const uint8_t* au = r + 32 + 12 * amax;
      for (int64_t t = 0; t < amax; ++t) {
        ag_vid[i * amax + t] = ai[3 * t];
        ag_eq[i * amax + t] = ai[3 * t + 1];
        ag_card[i * amax + t] = ai[3 * t + 2];
        ag_valid[i * amax + t] = au[2 * t];
        ag_subst[i * amax + t] = au[2 * t + 1];
      }
    }
  }
  if (dbg) std::fprintf(stderr, "fill3 phaseB %.1fs\n", now_s() - tB);
  return 0;
}

// Greedy sequential graph coloring over a CSR adjacency, processing
// vertices in the given order (a bandwidth-reducing order makes the
// coloring ALIGNED: equivalent local structures get the same color
// sequence, which keeps each color's rows in neighboring memory —
// random-priority MIS coloring scatters them). color must be filled
// with -1 by the caller. Returns the number of colors used.
// Conflict pairs (normalized u <= w, self-pairs dropped) in the SAME
// order as compile.py's numpy conflict_edges: arity classes ascending,
// factors in index order within a class, (i, j) in row-major triu
// order. Two-pass: conflict_count returns the pair total (or -1 when a
// factor's arity exceeds the working buffer), conflict_pairs writes
// the pairs. 'arity'/'offs' are plain int64 arrays (the caller casts
// once); 'vids' reads fmap.vid with a stride so the structured array
// is consumed in place.
int64_t conflict_count(int64_t F, const int64_t* arity,
                       const uint8_t* keep) {
  int64_t total = 0;
  for (int64_t f = 0; f < F; ++f) {
    if (keep && !keep[f]) continue;
    int64_t a = arity[f];
    if (a > kMaxArity) return -1;
    if (a >= 2) total += a * (a - 1) / 2;
  }
  return total;
}

// Writes (u, w) interleaved into one (m, 2) row-major buffer —
// conflict_edges returns exactly that shape (separate u/w arrays plus
// an np.stack copy cost 524 MB of extra traffic at 32M pairs).
int64_t conflict_pairs(int64_t F, const int64_t* arity, const int64_t* offs,
                       const uint8_t* vids, int64_t vid_stride,
                       const uint8_t* keep, int64_t* out_pairs) {
  Field mvid = {vids, vid_stride};
  std::vector<int64_t> classes;
  for (int64_t f = 0; f < F; ++f) {
    if (keep && !keep[f]) continue;
    int64_t a = arity[f];
    if (a < 2) continue;
    bool found = false;
    for (int64_t c : classes) found |= (c == a);
    if (!found) classes.push_back(a);
  }
  std::sort(classes.begin(), classes.end());
  int64_t m = 0;
  int64_t vbuf[kMaxArity];
  for (int64_t a : classes) {
    for (int64_t f = 0; f < F; ++f) {
      if (keep && !keep[f]) continue;
      if (arity[f] != a) continue;
      int64_t o = offs[f];
      for (int64_t j = 0; j < a; ++j) vbuf[j] = mvid.i64(o + j);
      for (int64_t i = 0; i < a; ++i) {
        for (int64_t j = i + 1; j < a; ++j) {
          int64_t u = vbuf[i], w = vbuf[j];
          if (u == w) continue;
          out_pairs[2 * m] = u < w ? u : w;
          out_pairs[2 * m + 1] = u < w ? w : u;
          ++m;
        }
      }
    }
  }
  return m;
}

// One-call coloring: build the CSR adjacency (counting sort), try a
// BFS parity 2-coloring, and when the graph is odd-cyclic fall back to
// greedy coloring in RCM order (same rank definition as rcm_rank
// below, same greedy as greedy_color — so the result is identical to
// compile.py's bipartite_coloring-else-greedy_coloring pipeline).
// The point is doing it all in ONE native pass: the Python pipeline
// pays a 2V-vertex double-cover CC for the bipartite test plus an
// argsort-based CSR build, ~130 s of numpy at 32M conflict pairs
// where this takes ~3 s. 'pairs' is (E, 2) row-major (u, w).
// Returns the number of colors (0 for an empty graph), or -1 on
// failure.
int64_t color_graph(int64_t n, int64_t E, const int64_t* pairs,
                    int64_t* color) {
  if (n == 0) return 0;
  std::vector<int64_t> deg(n, 0), offs(n + 1), adj, queue;
  adj.resize(2 * static_cast<size_t>(E));
  for (int64_t e = 0; e < E; ++e) {
    ++deg[pairs[2 * e]];
    ++deg[pairs[2 * e + 1]];
  }
  offs[0] = 0;
  for (int64_t v = 0; v < n; ++v) offs[v + 1] = offs[v] + deg[v];
  {
    std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t e = 0; e < E; ++e) {
      int64_t u = pairs[2 * e], w = pairs[2 * e + 1];
      adj[cur[u]++] = w;
      adj[cur[w]++] = u;
    }
  }
  // BFS parity attempt (color doubles as the parity/visited array)
  std::fill(color, color + n, int64_t{-1});
  queue.reserve(n);
  bool bipartite = true;
  int64_t max_par = 0;
  for (int64_t s = 0; s < n && bipartite; ++s) {
    if (color[s] >= 0) continue;
    color[s] = 0;
    queue.clear();
    queue.push_back(s);
    for (size_t h = 0; h < queue.size() && bipartite; ++h) {
      int64_t v = queue[h];
      int64_t want = color[v] ^ 1;
      for (int64_t e = offs[v]; e < offs[v + 1]; ++e) {
        int64_t u = adj[e];
        if (color[u] < 0) {
          color[u] = want;
          if (want > max_par) max_par = want;
          queue.push_back(u);
        } else if (color[u] != want) {
          bipartite = false;
          break;
        }
      }
    }
  }
  if (bipartite) return max_par + 1;
  // RCM order (comp labels by first occurrence, lowest-id min-degree
  // seed per component, level BFS, stable (comp, level, deg, id) sort,
  // reversed), then greedy smallest-available color in rank order.
  std::vector<int64_t> comp(n, -1), level(n, -1);
  int64_t n_comp = 0;
  for (int64_t s = 0; s < n; ++s) {
    if (comp[s] >= 0) continue;
    int64_t c = n_comp++;
    comp[s] = c;
    queue.clear();
    queue.push_back(s);
    for (size_t h = 0; h < queue.size(); ++h) {
      int64_t v = queue[h];
      for (int64_t e = offs[v]; e < offs[v + 1]; ++e) {
        int64_t u = adj[e];
        if (comp[u] < 0) {
          comp[u] = c;
          queue.push_back(u);
        }
      }
    }
  }
  std::vector<int64_t> seed(n_comp, -1);
  for (int64_t v = 0; v < n; ++v) {
    int64_t& s = seed[comp[v]];
    if (s < 0 || deg[v] < deg[s]) s = v;
  }
  for (int64_t c = 0; c < n_comp; ++c) {
    int64_t s = seed[c];
    level[s] = 0;
    queue.clear();
    queue.push_back(s);
    for (size_t h = 0; h < queue.size(); ++h) {
      int64_t v = queue[h];
      for (int64_t e = offs[v]; e < offs[v + 1]; ++e) {
        int64_t u = adj[e];
        if (level[u] < 0) {
          level[u] = level[v] + 1;
          queue.push_back(u);
        }
      }
    }
  }
  std::vector<int64_t> order(n);
  for (int64_t v = 0; v < n; ++v) order[v] = v;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) {
                     if (comp[x] != comp[y]) return comp[x] < comp[y];
                     if (level[x] != level[y]) return level[x] < level[y];
                     return deg[x] < deg[y];
                   });
  // rank-ascending visit sequence == order reversed (rank_out[order
  // [n-1-k]] = k in rcm_rank); greedy as in greedy_color below
  std::fill(color, color + n, int64_t{-1});
  std::vector<int64_t> mark;
  int64_t n_colors = 0;
  for (int64_t k = n - 1; k >= 0; --k) {
    int64_t v = order[k];
    for (int64_t e = offs[v]; e < offs[v + 1]; ++e) {
      int64_t c = color[adj[e]];
      if (c >= 0) {
        if (c >= static_cast<int64_t>(mark.size())) mark.resize(c + 1, -1);
        mark[c] = v;
      }
    }
    int64_t c = 0;
    while (c < static_cast<int64_t>(mark.size()) && mark[c] == v) ++c;
    color[v] = c;
    if (c + 1 > n_colors) n_colors = c + 1;
  }
  return n_colors;
}

// Reverse Cuthill-McKee-style rank, replicating compile.py's rcm_rank
// EXACTLY (component labels by first occurrence like scipy's weak
// connectivity, one lowest-id min-degree seed per component,
// level-synchronous BFS, stable order by (comp, level, deg, id),
// reversed). The numpy version's level loop is one vectorized pass per
// BFS LEVEL — thousands of rounds on a shuffled lattice; this is one
// pass total. Caller provides edge endpoints; rank_out has n slots.
// Returns 0, or -1 on allocation failure.
int rcm_rank(int64_t n, int64_t E, const int64_t* eu, const int64_t* ew,
             int64_t* rank_out) {
  std::vector<int64_t> deg(n, 0), offs(n + 1), adj, comp(n, -1),
      level(n, -1), queue;
  adj.resize(2 * static_cast<size_t>(E));
  for (int64_t e = 0; e < E; ++e) {
    ++deg[eu[e]];
    ++deg[ew[e]];
  }
  offs[0] = 0;
  for (int64_t v = 0; v < n; ++v) offs[v + 1] = offs[v] + deg[v];
  {
    std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t e = 0; e < E; ++e) {
      adj[cur[eu[e]]++] = ew[e];
      adj[cur[ew[e]]++] = eu[e];
    }
  }
  // components by BFS, labels in first-occurrence order
  queue.reserve(n);
  int64_t n_comp = 0;
  for (int64_t s = 0; s < n; ++s) {
    if (comp[s] >= 0) continue;
    int64_t c = n_comp++;
    comp[s] = c;
    queue.clear();
    queue.push_back(s);
    for (size_t h = 0; h < queue.size(); ++h) {
      int64_t v = queue[h];
      for (int64_t e = offs[v]; e < offs[v + 1]; ++e) {
        int64_t u = adj[e];
        if (comp[u] < 0) {
          comp[u] = c;
          queue.push_back(u);
        }
      }
    }
  }
  // lowest-id min-degree seed per component
  std::vector<int64_t> seed(n_comp, -1);
  for (int64_t v = 0; v < n; ++v) {
    int64_t& s = seed[comp[v]];
    if (s < 0 || deg[v] < deg[s]) s = v;
  }
  // multi-seed level-synchronous BFS (per component == simultaneous)
  for (int64_t c = 0; c < n_comp; ++c) {
    int64_t s = seed[c];
    level[s] = 0;
    queue.clear();
    queue.push_back(s);
    for (size_t h = 0; h < queue.size(); ++h) {
      int64_t v = queue[h];
      for (int64_t e = offs[v]; e < offs[v + 1]; ++e) {
        int64_t u = adj[e];
        if (level[u] < 0) {
          level[u] = level[v] + 1;
          queue.push_back(u);
        }
      }
    }
  }
  // stable order by (comp, level, deg), reversed -> rank
  std::vector<int64_t> order(n);
  for (int64_t v = 0; v < n; ++v) order[v] = v;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) {
                     if (comp[x] != comp[y]) return comp[x] < comp[y];
                     if (level[x] != level[y]) return level[x] < level[y];
                     return deg[x] < deg[y];
                   });
  for (int64_t k = 0; k < n; ++k) rank_out[order[n - 1 - k]] = k;
  return 0;
}

int64_t greedy_color(int64_t n, const int64_t* offs, const int64_t* adj,
                     const int64_t* order, int64_t* color) {
  std::vector<int64_t> mark;
  int64_t n_colors = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = order[i];
    for (int64_t e = offs[v]; e < offs[v + 1]; ++e) {
      int64_t c = color[adj[e]];
      if (c >= 0) {
        if (c >= static_cast<int64_t>(mark.size())) mark.resize(c + 1, -1);
        mark[c] = v;
      }
    }
    int64_t c = 0;
    while (c < static_cast<int64_t>(mark.size()) && mark[c] == v) ++c;
    color[v] = c;
    if (c + 1 > n_colors) n_colors = c + 1;
  }
  return n_colors;
}

// Text row formatter: writes n rows of "a b prob\n" ("%.{dec}f"-style
// fixed point) to path. b may be null (2-column id/value dumps).
// Returns 0, or -1 on I/O failure.
int dump_rows(const char* path, int64_t n, const int64_t* a,
              const int64_t* b, const double* x, int dec) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  char buf[1 << 16];
  std::setvbuf(fp, nullptr, _IOFBF, sizeof(buf));
  int64_t scale = 1;
  for (int d = 0; d < dec; ++d) scale *= 10;
  char line[96];
  for (int64_t i = 0; i < n; ++i) {
    double sx = x[i] * static_cast<double>(scale);
    // round-half-EVEN to match the numpy fallback's np.round (advisor
    // r2: llround's half-away-from-zero diverged on exact .5 ties)
    long long pm = static_cast<long long>(std::nearbyint(sx));
    const char* sign = pm < 0 ? "-" : "";
    unsigned long long ap = pm < 0 ? -static_cast<unsigned long long>(pm)
                                   : static_cast<unsigned long long>(pm);
    unsigned long long ip = ap / scale, fr = ap % scale;
    int len;
    if (b) {
      len = std::snprintf(line, sizeof(line), "%lld %lld %s%llu.%0*llu\n",
                          static_cast<long long>(a[i]),
                          static_cast<long long>(b[i]), sign, ip, dec, fr);
    } else {
      len = std::snprintf(line, sizeof(line), "%lld %s%llu.%0*llu\n",
                          static_cast<long long>(a[i]), sign, ip, dec, fr);
    }
    if (len <= 0 || std::fwrite(line, 1, len, fp) != static_cast<size_t>(len)) {
      std::fclose(fp);
      return -1;
    }
  }
  return std::fclose(fp) == 0 ? 0 : -1;
}

}  // extern "C"
