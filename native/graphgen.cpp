// graphgen — native factor-graph generator for numbskull-jax.
//
// Equivalent of the reference's only native component
// (reference: ising/ising.cpp): a standalone C++ tool that emits factor
// graphs in the DeepDive binary grounding format consumed by
// numbskull_jax.dataloading (and by the reference loaders). Written
// fresh; model families:
//
//   graphgen ising  <outdir> <N> <M> <weight>            Ising grid
//   graphgen coin   <outdir> <N> <a> <b> <c> [seed]      coin pairs w/ exact Z
//   graphgen voting <outdir> <V> <F> <degree> <w> [seed] high-degree OR
//
// Format (big-endian):
//   graph.meta      CSV: weights,variables,factors,edges
//   graph.weights   [weightId:i64][isFixed:u8][initialValue:f64]
//   graph.variables [variableId:i64][isEvidence:u8][initialValue:i64]
//                   [dataType:i16][cardinality:i64]
//   graph.factors   [factorFunction:i16][arity:i64]
//                   ([vid:i64][equalPredicate:i64] x arity)
//                   [weightId:i64][featureValue:f64]

#include <sys/stat.h>

#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <vector>

namespace {

// Portable big-endian emitters (no <endian.h> dependency).
void put_be(std::vector<uint8_t>& out, uint64_t v, int bytes) {
  for (int i = bytes - 1; i >= 0; --i)
    out.push_back(static_cast<uint8_t>((v >> (8 * i)) & 0xff));
}
void put_i64(std::vector<uint8_t>& out, int64_t v) {
  put_be(out, static_cast<uint64_t>(v), 8);
}
void put_i16(std::vector<uint8_t>& out, int16_t v) {
  put_be(out, static_cast<uint16_t>(v), 2);
}
void put_u8(std::vector<uint8_t>& out, uint8_t v) { out.push_back(v); }
void put_f64(std::vector<uint8_t>& out, double v) {
  uint64_t bits;
  static_assert(sizeof(bits) == sizeof(v), "f64 size");
  std::memcpy(&bits, &v, sizeof(bits));
  put_be(out, bits, 8);
}

void write_file(const std::string& path, const std::vector<uint8_t>& data) {
  FILE* f = std::fopen(path.c_str(), "wb");
  assert(f && "cannot open output file");
  if (!data.empty())
    assert(std::fwrite(data.data(), 1, data.size(), f) == data.size());
  std::fclose(f);
}

struct Weight {
  bool is_fixed;
  double initial_value;
};

struct Variable {
  uint8_t is_evidence;
  int64_t initial_value;
  int16_t data_type;
  int64_t cardinality;
};

struct Edge {
  int64_t vid;
  int64_t equal_predicate;
};

struct Factor {
  int16_t function;
  int64_t weight_id;
  double feature_value;
  std::vector<Edge> edges;
};

struct Graph {
  std::vector<Weight> weights;
  std::vector<Variable> variables;
  std::vector<Factor> factors;

  void write(const std::string& dir) const {
    ::mkdir(dir.c_str(), 0755);  // best-effort; fopen asserts below
    size_t edges = 0;
    for (const auto& f : factors) edges += f.edges.size();

    {
      char meta[160];
      std::snprintf(meta, sizeof meta, "%zu,%zu,%zu,%zu", weights.size(),
                    variables.size(), factors.size(), edges);
      FILE* f = std::fopen((dir + "/graph.meta").c_str(), "w");
      assert(f);
      std::fputs(meta, f);
      std::fclose(f);
    }
    {
      std::vector<uint8_t> buf;
      buf.reserve(weights.size() * 17);
      for (size_t i = 0; i < weights.size(); ++i) {
        put_i64(buf, static_cast<int64_t>(i));
        put_u8(buf, weights[i].is_fixed ? 1 : 0);
        put_f64(buf, weights[i].initial_value);
      }
      write_file(dir + "/graph.weights", buf);
    }
    {
      std::vector<uint8_t> buf;
      buf.reserve(variables.size() * 27);
      for (size_t i = 0; i < variables.size(); ++i) {
        const auto& v = variables[i];
        put_i64(buf, static_cast<int64_t>(i));
        put_u8(buf, v.is_evidence);
        put_i64(buf, v.initial_value);
        put_i16(buf, v.data_type);
        put_i64(buf, v.cardinality);
      }
      write_file(dir + "/graph.variables", buf);
    }
    {
      std::vector<uint8_t> buf;
      for (const auto& f : factors) {
        put_i16(buf, f.function);
        put_i64(buf, static_cast<int64_t>(f.edges.size()));
        for (const auto& e : f.edges) {
          put_i64(buf, e.vid);
          put_i64(buf, e.equal_predicate);
        }
        put_i64(buf, f.weight_id);
        put_f64(buf, f.feature_value);
      }
      write_file(dir + "/graph.factors", buf);
    }
  }
};

constexpr int16_t kFuncOr = 1;
constexpr int16_t kFuncEqual = 3;
constexpr int16_t kFuncIsTrue = 4;

Graph make_ising(int64_t n, int64_t m, double w) {
  Graph g;
  g.weights.push_back({true, w});
  g.variables.assign(n * m, Variable{0, 0, 0, 2});
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < m; ++j) {
      int64_t vid = i * m + j;
      if (i > 0)
        g.factors.push_back(
            {kFuncEqual, 0, 1.0, {{vid, 0}, {vid - m, 0}}});
      if (j > 0)
        g.factors.push_back(
            {kFuncEqual, 0, 1.0, {{vid, 0}, {vid - 1, 0}}});
    }
  }
  return g;
}

// Coin pairs with exact partition function — evidence data drawn from
// P(x1,x2) ∝ exp(a(2x1−1) + b(2x2−1) + c(2[x1==x2]−1)).
Graph make_coin(int64_t n, double a, double b, double c, uint64_t seed) {
  Graph g;
  g.weights.push_back({false, 0.0});
  g.weights.push_back({false, 0.0});
  g.weights.push_back({false, 0.0});

  double logit[4] = {-a - b + c, -a + b - c, a - b - c, a + b + c};
  double z[4];
  double zmax = logit[0];
  for (double l : logit) zmax = std::max(zmax, l);
  double acc = 0;
  for (int i = 0; i < 4; ++i) {
    acc += std::exp(logit[i] - zmax);
    z[i] = acc;
  }

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> uni(0.0, 1.0);
  for (int64_t i = 0; i < n; ++i) {
    double r = uni(rng) * z[3];
    int idx = 0;
    while (idx < 3 && r >= z[idx]) ++idx;
    int64_t x1 = (idx >> 1) & 1, x2 = idx & 1;
    int64_t v1 = 2 * i, v2 = 2 * i + 1;
    g.variables.push_back({1, x1, 0, 2});
    g.variables.push_back({1, x2, 0, 2});
    g.factors.push_back({kFuncIsTrue, 0, 1.0, {{v1, 0}}});
    g.factors.push_back({kFuncIsTrue, 1, 1.0, {{v2, 0}}});
    g.factors.push_back({kFuncEqual, 2, 1.0, {{v1, 0}, {v2, 0}}});
  }
  return g;
}

Graph make_voting(int64_t nv, int64_t nf, int64_t degree, double w,
                  uint64_t seed) {
  Graph g;
  g.weights.push_back({true, w});
  g.variables.assign(nv, Variable{0, 0, 0, 2});
  std::mt19937_64 rng(seed);
  std::vector<int64_t> pool(nv);
  for (int64_t i = 0; i < nv; ++i) pool[i] = i;
  for (int64_t f = 0; f < nf; ++f) {
    // partial Fisher–Yates: degree+1 distinct variables
    Factor fac{kFuncOr, 0, 1.0, {}};
    for (int64_t k = 0; k <= degree; ++k) {
      std::uniform_int_distribution<int64_t> pick(k, nv - 1);
      std::swap(pool[k], pool[pick(rng)]);
      fac.edges.push_back({pool[k], 0});
    }
    g.factors.push_back(std::move(fac));
  }
  return g;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage:\n"
                 "  graphgen ising  <outdir> <N> <M> <weight>\n"
                 "  graphgen coin   <outdir> <N> <a> <b> <c> [seed]\n"
                 "  graphgen voting <outdir> <V> <F> <degree> <w> [seed]\n");
    return 2;
  }
  std::string mode = argv[1];
  std::string dir = argv[2];
  Graph g;
  if (mode == "ising" && argc >= 6) {
    g = make_ising(std::atoll(argv[3]), std::atoll(argv[4]),
                   std::atof(argv[5]));
  } else if (mode == "coin" && argc >= 7) {
    g = make_coin(std::atoll(argv[3]), std::atof(argv[4]),
                  std::atof(argv[5]), std::atof(argv[6]),
                  argc > 7 ? std::atoll(argv[7]) : 0);
  } else if (mode == "voting" && argc >= 7) {
    g = make_voting(std::atoll(argv[3]), std::atoll(argv[4]),
                    std::atoll(argv[5]), std::atof(argv[6]),
                    argc > 7 ? std::atoll(argv[7]) : 0);
  } else {
    std::fprintf(stderr, "bad arguments for mode '%s'\n", mode.c_str());
    return 2;
  }
  g.write(dir);
  std::printf("wrote %zu weights, %zu variables, %zu factors to %s\n",
              g.weights.size(), g.variables.size(), g.factors.size(),
              dir.c_str());
  return 0;
}
