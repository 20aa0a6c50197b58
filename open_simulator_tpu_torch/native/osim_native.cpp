// Native host runtime of open_simulator_tpu_torch.
//
// The reference's host layer is compiled Go (CGO_ENABLED=0): its ingestion
// and accounting hot loops (resource.Quantity parsing in
// pkg/utils/utils.go:642-667, the scheduler cache bookkeeping) run at native
// speed. This is the port's copy of the JAX package's compiled host layer,
// exposed to Python over a C ABI via ctypes (native/__init__.py):
//
//   osim_parse_quantity_one — Kubernetes resource.Quantity parsing
//     (suffixes n/u/m/k/M/G/T/P/E, Ki..Ei, e/E exponents) into exact
//     canonical int64 units (milli and base, each under ceil and floor
//     rounding), matching utils/quantity.py:parse_quad bit for bit on every
//     value that fits int64. Values it cannot represent exactly return 0 and
//     the caller falls back to the exact-Fraction Python path.
//     Caller: utils/quantity.py:_native_parse_one.
//
//   osim_hash_rows — 128-bit per-row feature hashing for grouped
//     scheduling's identical-pod detection. Caller:
//     ops/grouped.py:_row_signature, under group_runs at the top of
//     ops/fast.py:schedule_batch_fast.
//
// Build: the loader runs `g++ -O2 -fPIC -shared -std=c++17` at first use,
// into the compile cache (ops/domain_pop.py:build_dir()); with no compiler
// the callers keep their pure-Python paths. Everything below the includes
// is the JAX package's source unchanged, so both compute the same bits.

#include <cstdint>
#include <cstring>

extern "C" {

typedef unsigned __int128 u128;

// Saturating/checked helpers -------------------------------------------------

static inline bool mul_overflow_u128(u128 a, u128 b, u128 *out) {
  if (a != 0 && b > (u128)-1 / a) return true;
  *out = a * b;
  return false;
}

static const u128 INT64_MAX_U = (u128)INT64_MAX;

// Parse one quantity string into milli/base values under both ceil and floor
// rounding (pod requests round up, node allocatable rounds down —
// core/objects.py:_canon_resources). Returns 1 on success, 0 when the string
// is invalid or out of int64 range.
static int parse_one(const char *s, int64_t len, int64_t *milli_ceil,
                     int64_t *milli_floor, int64_t *base_ceil,
                     int64_t *base_floor) {
  const char *p = s;
  const char *end = s + len;
  // strip ASCII whitespace (Python str.strip parity)
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' ||
                     *p == '\f' || *p == '\v'))
    p++;
  while (end > p && (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\n' ||
                     end[-1] == '\r' || end[-1] == '\f' || end[-1] == '\v'))
    end--;
  if (p == end) return 0;

  bool neg = false;
  if (*p == '+' || *p == '-') {
    neg = (*p == '-');
    p++;
  }

  // mantissa: digits [. digits]; at least one digit total
  u128 mant = 0;
  int frac_digits = 0;
  bool any_digit = false;
  bool overflow = false;
  while (p < end && *p >= '0' && *p <= '9') {
    any_digit = true;
    if (mant > ((u128)-1 - (*p - '0')) / 10) overflow = true;
    mant = mant * 10 + (u128)(*p - '0');
    p++;
  }
  if (p < end && *p == '.') {
    p++;
    while (p < end && *p >= '0' && *p <= '9') {
      any_digit = true;
      // keep at most 30 fractional digits; beyond that they cannot change
      // the ceil of a milli value for any suffix we accept, but we must
      // still know whether a nonzero tail exists for correct rounding
      if (frac_digits < 30) {
        if (mant > ((u128)-1 - (*p - '0')) / 10) overflow = true;
        mant = mant * 10 + (u128)(*p - '0');
        frac_digits++;
      } else if (*p != '0') {
        // nonzero beyond precision: force round-up by adding 1 ulp later
        overflow = true;  // rare; punt to exact Python path
      }
      p++;
    }
  }
  if (!any_digit || overflow) return 0;

  // suffix or exponent
  u128 mult_num = 1;
  u128 mult_den = 1;
  if (p < end) {
    char c = *p;
    if (c == 'e' || c == 'E') {
      p++;
      bool eneg = false;
      if (p < end && (*p == '+' || *p == '-')) {
        eneg = (*p == '-');
        p++;
      }
      if (p == end) return 0;
      int ev = 0;
      while (p < end && *p >= '0' && *p <= '9') {
        ev = ev * 10 + (*p - '0');
        if (ev > 40) return 0;  // out of int64 range anyway; exact path
        p++;
      }
      if (p != end) return 0;
      for (int i = 0; i < ev; i++) {
        if (eneg) {
          if (mul_overflow_u128(mult_den, 10, &mult_den)) return 0;
        } else if (mul_overflow_u128(mult_num, 10, &mult_num)) {
          return 0;
        }
      }
    } else {
      // binary suffixes Ki..Ei and decimal n u m k M G T P E
      static const u128 KI = 1024;
      u128 bin = 0;
      if (end - p == 2 && p[1] == 'i') {
        switch (p[0]) {
          case 'K': bin = KI; break;
          case 'M': bin = KI * KI; break;
          case 'G': bin = KI * KI * KI; break;
          case 'T': bin = KI * KI * KI * KI; break;
          case 'P': bin = KI * KI * KI * KI * KI; break;
          case 'E': bin = KI * KI * KI * KI * KI * KI; break;
          default: return 0;
        }
        mult_num = bin;
      } else if (end - p == 1) {
        switch (p[0]) {
          case 'n': mult_den = 1000000000ull; break;
          case 'u': mult_den = 1000000ull; break;
          case 'm': mult_den = 1000ull; break;
          case 'k': mult_num = 1000ull; break;
          case 'M': mult_num = 1000000ull; break;
          case 'G': mult_num = 1000000000ull; break;
          case 'T': mult_num = 1000000000000ull; break;
          case 'P': mult_num = 1000000000000000ull; break;
          case 'E': mult_num = 1000000000000000000ull; break;
          default: return 0;
        }
      } else {
        return 0;
      }
    }
  }

  // value = mant * mult_num / (mult_den * 10^frac_digits)
  // 10^frac_digits can exceed u128 for 30 digits? 10^30 < 2^100, ok; combined
  // with mult_den (<=1e9) still < 2^128.
  u128 den = mult_den;
  for (int i = 0; i < frac_digits; i++) {
    if (mul_overflow_u128(den, 10, &den)) return 0;
  }

  u128 num;
  if (mul_overflow_u128(mant, mult_num, &num)) return 0;

  // |value| = num/den. For positive v: ceil = q + (r?1:0), floor = q.
  // For negative v: ceil(-num/den) = -q, floor(-num/den) = -(q + (r?1:0)).
  u128 q = num / den;
  u128 r = num % den;
  u128 up = r ? q + 1 : q;
  if (up > INT64_MAX_U) return 0;
  *base_ceil = neg ? -(int64_t)q : (int64_t)up;
  *base_floor = neg ? -(int64_t)up : (int64_t)q;

  u128 num_m;
  if (mul_overflow_u128(num, 1000, &num_m)) return 0;
  u128 qm = num_m / den;
  u128 rm = num_m % den;
  u128 upm = rm ? qm + 1 : qm;
  if (upm > INT64_MAX_U) return 0;
  *milli_ceil = neg ? -(int64_t)qm : (int64_t)upm;
  *milli_floor = neg ? -(int64_t)upm : (int64_t)qm;
  return 1;
}

// Scalar entry point for the lru-cached single-string path (cheap ctypes
// call: four byref int64 outputs, no array marshalling).
int osim_parse_quantity_one(const char *s, int64_t len, int64_t *milli_ceil,
                            int64_t *milli_floor, int64_t *base_ceil,
                            int64_t *base_floor) {
  return parse_one(s, len, milli_ceil, milli_floor, base_ceil, base_floor);
}

// 128-bit row hashing ---------------------------------------------------------
// splitmix64-based mixing over 8-byte chunks with two independent seeds; used
// only to detect runs of identical pod rows, where a collision between
// ADJACENT differing rows would merge two groups. Two independent 64-bit
// streams make that probability negligible (~2^-128 per pair).

static inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

void osim_hash_rows(const uint8_t *data, int64_t n_rows, int64_t row_bytes,
                    uint64_t *out /* [n_rows*2] */) {
  for (int64_t i = 0; i < n_rows; i++) {
    const uint8_t *row = data + i * row_bytes;
    uint64_t h1 = 0x243f6a8885a308d3ull;  // pi digits: arbitrary fixed seeds
    uint64_t h2 = 0x13198a2e03707344ull;
    int64_t j = 0;
    for (; j + 8 <= row_bytes; j += 8) {
      uint64_t chunk;
      memcpy(&chunk, row + j, 8);
      h1 = mix64(h1 ^ chunk);
      h2 = mix64(h2 + chunk * 0x9e3779b97f4a7c15ull);
    }
    if (j < row_bytes) {
      uint64_t chunk = 0;
      memcpy(&chunk, row + j, row_bytes - j);
      h1 = mix64(h1 ^ chunk);
      h2 = mix64(h2 + chunk * 0x9e3779b97f4a7c15ull);
    }
    out[i * 2] = mix64(h1 ^ (uint64_t)row_bytes);
    out[i * 2 + 1] = mix64(h2 ^ (uint64_t)row_bytes);
  }
}

}  // extern "C"
