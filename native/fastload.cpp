// fastload — native DeepDive binary factor-stream scanner.
//
// The graph.factors file is a variable-length record stream (reference
// format: numbskull/dataloading.py:190-237); scanning it is inherently
// sequential. numbskull_jax.dataloading parses it with vectorized numpy
// over equal-arity runs, which degrades on streams with rapidly
// alternating arities; this native scanner is O(bytes) regardless.
// Exposed via ctypes (numbskull_jax.dataloading picks it up when built:
// `make -C native libfastload.so`).

#include <cstdint>
#include <cstring>

namespace {

inline uint64_t be64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  v = __builtin_bswap64(v);
#endif
  return v;
}

inline uint16_t be16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  v = __builtin_bswap16(v);
#endif
  return v;
}

inline double bef64(const uint8_t* p) {
  uint64_t bits = be64(p);
  double d;
  std::memcpy(&d, &bits, 8);
  return d;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 on truncated stream, -2 on edge overflow.
int fastload_factors(const uint8_t* data, int64_t size, int64_t nfactors,
                     int64_t nedges, int16_t* factor_function,
                     int64_t* arity, int64_t* ftv_offset,
                     int64_t* weight_id, double* feature_value,
                     int64_t* fmap_vid, int64_t* fmap_equal) {
  int64_t off = 0;
  int64_t e = 0;
  for (int64_t i = 0; i < nfactors; ++i) {
    if (off + 10 > size) return -1;
    factor_function[i] = static_cast<int16_t>(be16(data + off));
    int64_t a = static_cast<int64_t>(be64(data + off + 2));
    off += 10;
    if (off + 16 * a + 16 > size) return -1;
    if (e + a > nedges) return -2;
    arity[i] = a;
    ftv_offset[i] = e;
    for (int64_t k = 0; k < a; ++k) {
      fmap_vid[e] = static_cast<int64_t>(be64(data + off));
      fmap_equal[e] = static_cast<int64_t>(be64(data + off + 8));
      off += 16;
      ++e;
    }
    weight_id[i] = static_cast<int64_t>(be64(data + off));
    feature_value[i] = bef64(data + off + 8);
    off += 16;
  }
  return 0;
}

}  // extern "C"
