// Native host curve arithmetic for quisquis_tpu_torch, the PyTorch/CUDA port.
//
// 51-bit-limb GF(2^255-19) with unsigned __int128 products, extended
// twisted-Edwards points, windowed scalar multiplication, Pippenger MSM and
// ristretto255 encode/decode. This accelerates the *host* prover/verifier
// paths (transcript-sequential proof construction); the batched device
// paths run on the GPU. Interfaces use canonical little-endian byte arrays
// (32 B field/scalar, 4x32 B extended point), so the Python exact backend
// can dispatch here transparently. Built from scratch; validated against
// the pure-Python backend in tests.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;
typedef uint64_t u64;

extern "C" {

// ---------------------------------------------------------------------------
// field: 5 x 51-bit limbs
// ---------------------------------------------------------------------------

struct Fe {
  u64 v[5];
};

static const u64 MASK51 = ((u64)1 << 51) - 1;

static void fe_frombytes(Fe *r, const uint8_t *s) {
  u64 h[4];
  std::memcpy(h, s, 32);
  r->v[0] = h[0] & MASK51;
  r->v[1] = ((h[0] >> 51) | (h[1] << 13)) & MASK51;
  r->v[2] = ((h[1] >> 38) | (h[2] << 26)) & MASK51;
  r->v[3] = ((h[2] >> 25) | (h[3] << 39)) & MASK51;
  r->v[4] = (h[3] >> 12) & MASK51;
}

static void fe_carry(Fe *r) {
  u64 c;
  for (int rep = 0; rep < 2; rep++) {
    c = r->v[0] >> 51; r->v[0] &= MASK51; r->v[1] += c;
    c = r->v[1] >> 51; r->v[1] &= MASK51; r->v[2] += c;
    c = r->v[2] >> 51; r->v[2] &= MASK51; r->v[3] += c;
    c = r->v[3] >> 51; r->v[3] &= MASK51; r->v[4] += c;
    c = r->v[4] >> 51; r->v[4] &= MASK51; r->v[0] += 19 * c;
  }
}

static void fe_tobytes(uint8_t *s, const Fe *a) {
  Fe t = *a;
  fe_carry(&t);
  // canonical: add 19, propagate, subtract 2^255
  u64 q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  u64 c;
  c = t.v[0] >> 51; t.v[0] &= MASK51; t.v[1] += c;
  c = t.v[1] >> 51; t.v[1] &= MASK51; t.v[2] += c;
  c = t.v[2] >> 51; t.v[2] &= MASK51; t.v[3] += c;
  c = t.v[3] >> 51; t.v[3] &= MASK51; t.v[4] += c;
  t.v[4] &= MASK51;
  u64 h[4];
  h[0] = t.v[0] | (t.v[1] << 51);
  h[1] = (t.v[1] >> 13) | (t.v[2] << 38);
  h[2] = (t.v[2] >> 26) | (t.v[3] << 25);
  h[3] = (t.v[3] >> 39) | (t.v[4] << 12);
  std::memcpy(s, h, 32);
}

static void fe_add(Fe *r, const Fe *a, const Fe *b) {
  for (int i = 0; i < 5; i++) r->v[i] = a->v[i] + b->v[i];
  fe_carry(r);
}

static void fe_sub(Fe *r, const Fe *a, const Fe *b) {
  // a + 8p - b  (8p limbwise: 8*(2^51-19), 8*(2^51-1) x4)
  static const u64 P0 = (MASK51 - 18) * 8, PI = MASK51 * 8;
  r->v[0] = a->v[0] + P0 - b->v[0];
  for (int i = 1; i < 5; i++) r->v[i] = a->v[i] + PI - b->v[i];
  fe_carry(r);
}

static void fe_neg(Fe *r, const Fe *a) {
  Fe z;
  std::memset(&z, 0, sizeof z);
  fe_sub(r, &z, a);
}

static void fe_mul(Fe *r, const Fe *a, const Fe *b) {
  u128 t0, t1, t2, t3, t4;
  u64 a0 = a->v[0], a1 = a->v[1], a2 = a->v[2], a3 = a->v[3], a4 = a->v[4];
  u64 b0 = b->v[0], b1 = b->v[1], b2 = b->v[2], b3 = b->v[3], b4 = b->v[4];
  u64 a1_19 = 19 * a1, a2_19 = 19 * a2, a3_19 = 19 * a3, a4_19 = 19 * a4;

  t0 = (u128)a0 * b0 + (u128)a4_19 * b1 + (u128)a3_19 * b2 + (u128)a2_19 * b3 + (u128)a1_19 * b4;
  t1 = (u128)a1 * b0 + (u128)a0 * b1 + (u128)a4_19 * b2 + (u128)a3_19 * b3 + (u128)a2_19 * b4;
  t2 = (u128)a2 * b0 + (u128)a1 * b1 + (u128)a0 * b2 + (u128)a4_19 * b3 + (u128)a3_19 * b4;
  t3 = (u128)a3 * b0 + (u128)a2 * b1 + (u128)a1 * b2 + (u128)a0 * b3 + (u128)a4_19 * b4;
  t4 = (u128)a4 * b0 + (u128)a3 * b1 + (u128)a2 * b2 + (u128)a1 * b3 + (u128)a0 * b4;

  u64 c;
  u64 r0, r1, r2, r3, r4;
  r0 = (u64)t0 & MASK51; c = (u64)(t0 >> 51);
  t1 += c; r1 = (u64)t1 & MASK51; c = (u64)(t1 >> 51);
  t2 += c; r2 = (u64)t2 & MASK51; c = (u64)(t2 >> 51);
  t3 += c; r3 = (u64)t3 & MASK51; c = (u64)(t3 >> 51);
  t4 += c; r4 = (u64)t4 & MASK51; c = (u64)(t4 >> 51);
  r0 += 19 * c; c = r0 >> 51; r0 &= MASK51; r1 += c;
  r->v[0] = r0; r->v[1] = r1; r->v[2] = r2; r->v[3] = r3; r->v[4] = r4;
}

static void fe_sq(Fe *r, const Fe *a) { fe_mul(r, a, a); }

static void fe_pow2k(Fe *r, const Fe *a, int k) {
  *r = *a;
  for (int i = 0; i < k; i++) fe_sq(r, r);
}

static void fe_invert(Fe *r, const Fe *z) {
  Fe t0, t1, t2, t3;
  fe_sq(&t0, z);                       // 2
  fe_pow2k(&t1, &t0, 2);               // 8
  fe_mul(&t1, z, &t1);                 // 9
  fe_mul(&t0, &t0, &t1);               // 11
  fe_sq(&t2, &t0);                     // 22
  fe_mul(&t1, &t1, &t2);               // 31
  fe_pow2k(&t2, &t1, 5); fe_mul(&t1, &t2, &t1);    // 2^10-1
  fe_pow2k(&t2, &t1, 10); fe_mul(&t2, &t2, &t1);   // 2^20-1
  fe_pow2k(&t3, &t2, 20); fe_mul(&t2, &t3, &t2);   // 2^40-1
  fe_pow2k(&t2, &t2, 10); fe_mul(&t1, &t2, &t1);   // 2^50-1
  fe_pow2k(&t2, &t1, 50); fe_mul(&t2, &t2, &t1);   // 2^100-1
  fe_pow2k(&t3, &t2, 100); fe_mul(&t2, &t3, &t2);  // 2^200-1
  fe_pow2k(&t2, &t2, 50); fe_mul(&t1, &t2, &t1);   // 2^250-1
  fe_pow2k(&t1, &t1, 5); fe_mul(r, &t1, &t0);      // 2^255-21
}

static void fe_pow_p58(Fe *r, const Fe *z) {  // z^(2^252-3)
  Fe t0, t1, t2, t3;
  fe_sq(&t0, z);
  fe_pow2k(&t1, &t0, 2);
  fe_mul(&t1, z, &t1);
  fe_mul(&t0, &t0, &t1);
  fe_sq(&t2, &t0);
  fe_mul(&t1, &t1, &t2);
  fe_pow2k(&t2, &t1, 5); fe_mul(&t1, &t2, &t1);
  fe_pow2k(&t2, &t1, 10); fe_mul(&t2, &t2, &t1);
  fe_pow2k(&t3, &t2, 20); fe_mul(&t2, &t3, &t2);
  fe_pow2k(&t2, &t2, 10); fe_mul(&t1, &t2, &t1);
  fe_pow2k(&t2, &t1, 50); fe_mul(&t2, &t2, &t1);
  fe_pow2k(&t3, &t2, 100); fe_mul(&t2, &t3, &t2);
  fe_pow2k(&t2, &t2, 50); fe_mul(&t1, &t2, &t1);   // 2^250-1
  fe_pow2k(&t1, &t1, 2); fe_mul(r, &t1, z);        // 2^252-3
}

static int fe_eq(const Fe *a, const Fe *b) {
  uint8_t ba[32], bb[32];
  fe_tobytes(ba, a);
  fe_tobytes(bb, b);
  return std::memcmp(ba, bb, 32) == 0;
}

static int fe_isneg(const Fe *a) {
  uint8_t b[32];
  fe_tobytes(b, a);
  return b[0] & 1;
}

static int fe_iszero(const Fe *a) {
  uint8_t b[32];
  fe_tobytes(b, a);
  for (int i = 0; i < 32; i++)
    if (b[i]) return 0;
  return 1;
}

// runtime constants, injected from Python at init (avoids duplicating
// constant derivation): d, 2d, sqrt(-1), invsqrt(a-d), sqrt(ad-1),
// (1-d^2), (d-1)^2
static Fe C_D, C_D2, C_SQRTM1, C_INVSQRT_AMD, C_SQRT_ADM1, C_OMDS, C_DMOS;
static int g_init = 0;

void qq_curve_init(const uint8_t *d, const uint8_t *d2, const uint8_t *sqrtm1,
                   const uint8_t *invsqrt_amd, const uint8_t *sqrt_adm1,
                   const uint8_t *omds, const uint8_t *dmos) {
  fe_frombytes(&C_D, d);
  fe_frombytes(&C_D2, d2);
  fe_frombytes(&C_SQRTM1, sqrtm1);
  fe_frombytes(&C_INVSQRT_AMD, invsqrt_amd);
  fe_frombytes(&C_SQRT_ADM1, sqrt_adm1);
  fe_frombytes(&C_OMDS, omds);
  fe_frombytes(&C_DMOS, dmos);
  g_init = 1;
}

// (was_square, r = sqrt(u/v) or sqrt(i*u/v))
static int fe_sqrt_ratio(Fe *r, const Fe *u, const Fe *v) {
  Fe v3, v7, t, check, neg_u, neg_u_i;
  fe_sq(&v3, v); fe_mul(&v3, &v3, v);
  fe_sq(&v7, &v3); fe_mul(&v7, &v7, v);
  fe_mul(&t, u, &v7);
  fe_pow_p58(&t, &t);
  fe_mul(&t, &t, &v3);
  fe_mul(&t, &t, u);          // r = u*v3*(u*v7)^((p-5)/8)
  fe_sq(&check, &t); fe_mul(&check, &check, v);
  fe_neg(&neg_u, u);
  fe_mul(&neg_u_i, &neg_u, &C_SQRTM1);
  int correct = fe_eq(&check, u);
  int flipped = fe_eq(&check, &neg_u);
  int flipped_i = fe_eq(&check, &neg_u_i);
  if (flipped || flipped_i) fe_mul(&t, &t, &C_SQRTM1);
  if (fe_isneg(&t)) fe_neg(&t, &t);
  *r = t;
  return correct || flipped;
}

// ---------------------------------------------------------------------------
// points: extended coordinates
// ---------------------------------------------------------------------------

struct Pt {
  Fe x, y, z, t;
};

static void pt_identity(Pt *p) {
  std::memset(p, 0, sizeof(Pt));
  p->y.v[0] = 1;
  p->z.v[0] = 1;
}

static void pt_add(Pt *r, const Pt *p, const Pt *q) {
  Fe A, B, C, D, E, F, G, H, t1, t2;
  fe_sub(&t1, &p->y, &p->x);
  fe_sub(&t2, &q->y, &q->x);
  fe_mul(&A, &t1, &t2);
  fe_add(&t1, &p->y, &p->x);
  fe_add(&t2, &q->y, &q->x);
  fe_mul(&B, &t1, &t2);
  fe_mul(&C, &p->t, &C_D2);
  fe_mul(&C, &C, &q->t);
  fe_mul(&D, &p->z, &q->z);
  fe_add(&D, &D, &D);
  fe_sub(&E, &B, &A);
  fe_sub(&F, &D, &C);
  fe_add(&G, &D, &C);
  fe_add(&H, &B, &A);
  fe_mul(&r->x, &E, &F);
  fe_mul(&r->y, &G, &H);
  fe_mul(&r->z, &F, &G);
  fe_mul(&r->t, &E, &H);
}

static void pt_double(Pt *r, const Pt *p) {
  Fe A, B, C, E, F, G, H, t1;
  fe_sq(&A, &p->x);
  fe_sq(&B, &p->y);
  fe_sq(&C, &p->z);
  fe_add(&C, &C, &C);
  fe_add(&H, &A, &B);
  fe_add(&t1, &p->x, &p->y);
  fe_sq(&t1, &t1);
  fe_sub(&E, &H, &t1);
  fe_sub(&G, &A, &B);
  fe_add(&F, &C, &G);
  fe_mul(&r->x, &E, &F);
  fe_mul(&r->y, &G, &H);
  fe_mul(&r->z, &F, &G);
  fe_mul(&r->t, &E, &H);
}

// point wire format: 4 x 32-byte LE field elements (x, y, z, t)
static void pt_load(Pt *p, const uint8_t *b) {
  fe_frombytes(&p->x, b);
  fe_frombytes(&p->y, b + 32);
  fe_frombytes(&p->z, b + 64);
  fe_frombytes(&p->t, b + 96);
}

static void pt_store(uint8_t *b, const Pt *p) {
  fe_tobytes(b, &p->x);
  fe_tobytes(b + 32, &p->y);
  fe_tobytes(b + 64, &p->z);
  fe_tobytes(b + 96, &p->t);
}

void qq_pt_add(const uint8_t *p, const uint8_t *q, uint8_t *out) {
  Pt a, b, r;
  pt_load(&a, p);
  pt_load(&b, q);
  pt_add(&r, &a, &b);
  pt_store(out, &r);
}

void qq_pt_double(const uint8_t *p, uint8_t *out) {
  Pt a, r;
  pt_load(&a, p);
  pt_double(&r, &a);
  pt_store(out, &r);
}

// scalar: 32-byte LE (already reduced mod l); 4-bit windowed ladder
static void pt_scalar_mul(Pt *r, const uint8_t *scalar, const Pt *p) {
  Pt table[16];
  pt_identity(&table[0]);
  table[1] = *p;
  for (int k = 2; k < 16; k++) {
    if (k % 2 == 0) pt_double(&table[k], &table[k / 2]);
    else pt_add(&table[k], &table[k - 1], p);
  }
  pt_identity(r);
  int started = 0;
  for (int i = 31; i >= 0; i--) {
    for (int half = 1; half >= 0; half--) {
      int nib = half ? (scalar[i] >> 4) : (scalar[i] & 15);
      if (started) {
        pt_double(r, r); pt_double(r, r); pt_double(r, r); pt_double(r, r);
        if (nib) pt_add(r, r, &table[nib]);
      } else if (nib) {
        *r = table[nib];
        started = 1;
      }
    }
  }
}

void qq_pt_scalar_mul(const uint8_t *scalar, const uint8_t *p, uint8_t *out) {
  Pt a, r;
  pt_load(&a, p);
  pt_scalar_mul(&r, scalar, &a);
  pt_store(out, &r);
}

// Strauss (interleaved windowed) MSM for small n: one shared 252-doubling
// chain, per-point 16-entry tables. Cost ~ 78n + 252 point ops vs
// Pippenger's windows*(n + 2*2^c) — wins below n ~ 96 because the bucket
// sweep is fixed overhead per window.
static void msm_strauss(u64 n, const uint8_t *scalars, const uint8_t *points,
                        Pt *outp) {
  Pt *tables = new Pt[n * 16];
  for (u64 i = 0; i < n; i++) {
    Pt *t = tables + i * 16;
    pt_identity(&t[0]);
    pt_load(&t[1], points + 128 * i);
    for (int k = 2; k < 16; k++) {
      if (k % 2 == 0) pt_double(&t[k], &t[k / 2]);
      else pt_add(&t[k], &t[k - 1], &t[1]);
    }
  }
  Pt r;
  pt_identity(&r);
  int started = 0;
  for (int i = 31; i >= 0; i--) {
    for (int half = 1; half >= 0; half--) {
      if (started) {
        pt_double(&r, &r); pt_double(&r, &r);
        pt_double(&r, &r); pt_double(&r, &r);
      }
      for (u64 j = 0; j < n; j++) {
        int nib = half ? (scalars[32 * j + i] >> 4) : (scalars[32 * j + i] & 15);
        if (!nib) continue;
        if (started) pt_add(&r, &r, &tables[j * 16 + nib]);
        else { r = tables[j * 16 + nib]; started = 1; }
      }
    }
  }
  delete[] tables;
  *outp = r;
}

// Pippenger MSM over one chunk: scalars[n*32], points[n*128] -> *outp
static void msm_chunk(u64 n, const uint8_t *scalars, const uint8_t *points,
                      Pt *outp) {
  Pt result;
  pt_identity(&result);
  if (n == 0) { *outp = result; return; }
  if (n < 96) { msm_strauss(n, scalars, points, outp); return; }
  // window width: minimize windows*(n + 2*2^c) + 253 doublings;
  // mid sizes want narrower windows than the classic n/log heuristic
  // because the bucket sweep costs 2*2^c adds per window
  int c = n < 32 ? 4 : (n < 160 ? 5 : (n < 500 ? 6 : 8));
  int nbuckets = 1 << c;
  int windows = (253 + c - 1) / c;
  Pt *pts = new Pt[n];
  for (u64 i = 0; i < n; i++) pt_load(&pts[i], points + 128 * i);
  Pt *buckets = new Pt[nbuckets];
  bool *used = new bool[nbuckets];
  for (int w = windows - 1; w >= 0; w--) {
    if (w != windows - 1)
      for (int k = 0; k < c; k++) pt_double(&result, &result);
    std::memset(used, 0, nbuckets);
    int shift = w * c;
    for (u64 i = 0; i < n; i++) {
      // digit = bits [shift, shift+c) of scalar i
      int byte = shift >> 3, off = shift & 7;
      u64 window = 0;
      for (int k = 0; k < 4 && byte + k < 32; k++)
        window |= (u64)scalars[32 * i + byte + k] << (8 * k);
      int digit = (window >> off) & (nbuckets - 1);
      if (!digit) continue;
      if (!used[digit]) { buckets[digit] = pts[i]; used[digit] = true; }
      else pt_add(&buckets[digit], &buckets[digit], &pts[i]);
    }
    Pt running, acc;
    int have_r = 0, have_a = 0;
    for (int b = nbuckets - 1; b >= 1; b--) {
      if (used[b]) {
        if (have_r) pt_add(&running, &running, &buckets[b]);
        else { running = buckets[b]; have_r = 1; }
      }
      if (have_r) {
        if (have_a) pt_add(&acc, &acc, &running);
        else { acc = running; have_a = 1; }
      }
    }
    if (have_a) pt_add(&result, &result, &acc);
  }
  *outp = result;
  delete[] pts;
  delete[] buckets;
  delete[] used;
}

static unsigned pool_threads(u64 n, u64 min_per_thread) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  u64 want = n / min_per_thread;
  if (want < 1) want = 1;
  return (unsigned)(want < hw ? want : hw);
}

// Pippenger MSM (threaded): scalars[n*32], points[n*128] -> out[128].
// Chunk results combine by group addition, so the encoded output is
// independent of the thread split.
void qq_pt_msm(u64 n, const uint8_t *scalars, const uint8_t *points,
               uint8_t *out) {
  unsigned nt = pool_threads(n, 512);
  if (nt <= 1) {
    Pt r;
    msm_chunk(n, scalars, points, &r);
    pt_store(out, &r);
    return;
  }
  std::vector<Pt> partial(nt);
  std::vector<std::thread> ths;
  u64 per = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    u64 lo = per * t, hi = lo + per < n ? lo + per : n;
    ths.emplace_back([&, lo, hi, t]() {
      msm_chunk(hi - lo, scalars + 32 * lo, points + 128 * lo, &partial[t]);
    });
  }
  for (auto &th : ths) th.join();
  Pt r = partial[0];
  for (unsigned t = 1; t < nt; t++) pt_add(&r, &r, &partial[t]);
  pt_store(out, &r);
}

// ---------------------------------------------------------------------------
// ristretto encode / decode
// ---------------------------------------------------------------------------

void qq_ristretto_encode(const uint8_t *point, uint8_t *out32) {
  Pt p;
  pt_load(&p, point);
  Fe u1, u2, t1, invsqrt, den1, den2, z_inv, ix0, iy0, ench, x, y, den_inv, s;
  fe_add(&u1, &p.z, &p.y);
  fe_sub(&t1, &p.z, &p.y);
  fe_mul(&u1, &u1, &t1);
  fe_mul(&u2, &p.x, &p.y);
  fe_sq(&t1, &u2);
  fe_mul(&t1, &t1, &u1);
  Fe one;
  std::memset(&one, 0, sizeof one);
  one.v[0] = 1;
  fe_sqrt_ratio(&invsqrt, &one, &t1);
  fe_mul(&den1, &invsqrt, &u1);
  fe_mul(&den2, &invsqrt, &u2);
  fe_mul(&z_inv, &den1, &den2);
  fe_mul(&z_inv, &z_inv, &p.t);
  fe_mul(&ix0, &p.x, &C_SQRTM1);
  fe_mul(&iy0, &p.y, &C_SQRTM1);
  fe_mul(&ench, &den1, &C_INVSQRT_AMD);
  fe_mul(&t1, &p.t, &z_inv);
  if (fe_isneg(&t1)) {
    x = iy0; y = ix0; den_inv = ench;
  } else {
    x = p.x; y = p.y; den_inv = den2;
  }
  fe_mul(&t1, &x, &z_inv);
  if (fe_isneg(&t1)) fe_neg(&y, &y);
  fe_sub(&s, &p.z, &y);
  fe_mul(&s, &s, &den_inv);
  if (fe_isneg(&s)) fe_neg(&s, &s);
  fe_tobytes(out32, &s);
}

int qq_ristretto_decode(const uint8_t *in32, uint8_t *point_out) {
  // canonicity check
  uint8_t canon[32];
  Fe s;
  fe_frombytes(&s, in32);
  fe_tobytes(canon, &s);
  if (std::memcmp(canon, in32, 32) != 0) return 0;
  if (in32[0] & 1) return 0;
  Fe ss, u1, u2, u2sq, v, invsqrt, den_x, den_y, x, y, t, one, t1;
  std::memset(&one, 0, sizeof one);
  one.v[0] = 1;
  fe_sq(&ss, &s);
  fe_sub(&u1, &one, &ss);
  fe_add(&u2, &one, &ss);
  fe_sq(&u2sq, &u2);
  fe_sq(&t1, &u1);
  fe_mul(&v, &t1, &C_D);
  fe_neg(&v, &v);
  fe_sub(&v, &v, &u2sq);
  fe_mul(&t1, &v, &u2sq);
  int was_square = fe_sqrt_ratio(&invsqrt, &one, &t1);
  fe_mul(&den_x, &invsqrt, &u2);
  fe_mul(&den_y, &invsqrt, &den_x);
  fe_mul(&den_y, &den_y, &v);
  fe_add(&t1, &s, &s);
  fe_mul(&x, &t1, &den_x);
  if (fe_isneg(&x)) fe_neg(&x, &x);
  fe_mul(&y, &u1, &den_y);
  fe_mul(&t, &x, &y);
  if (!was_square || fe_isneg(&t) || fe_iszero(&y)) return 0;
  Pt p;
  p.x = x; p.y = y; p.z = one; p.t = t;
  pt_store(point_out, &p);
  return 1;
}

// fixed-base: 64 windows x 16 entries of (16^w * k) * B, built lazily from
// an injected basepoint
static Pt g_base_table[64][16];
static int g_base_ready = 0;

void qq_set_basepoint(const uint8_t *basepoint) {
  Pt base;
  pt_load(&base, basepoint);
  for (int w = 0; w < 64; w++) {
    pt_identity(&g_base_table[w][0]);
    g_base_table[w][1] = base;
    for (int k = 2; k < 16; k++)
      pt_add(&g_base_table[w][k], &g_base_table[w][k - 1], &base);
    // base <- 16 * base
    for (int d = 0; d < 4; d++) pt_double(&base, &base);
  }
  g_base_ready = 1;
}

void qq_pt_base_mul(const uint8_t *scalar, uint8_t *out) {
  Pt r;
  pt_identity(&r);
  int have = 0;
  for (int i = 0; i < 32; i++) {
    int lo = scalar[i] & 15, hi = scalar[i] >> 4;
    if (lo) {
      if (have) pt_add(&r, &r, &g_base_table[2 * i][lo]);
      else { r = g_base_table[2 * i][lo]; have = 1; }
    }
    if (hi) {
      if (have) pt_add(&r, &r, &g_base_table[2 * i + 1][hi]);
      else { r = g_base_table[2 * i + 1][hi]; have = 1; }
    }
  }
  pt_store(out, &r);
}

int qq_base_ready() { return g_base_ready; }

int qq_initialized() { return g_init; }

// ---------------------------------------------------------------------------
// batched host ops (threaded): the Python side pays one ctypes marshal for
// the whole batch instead of one per element
// ---------------------------------------------------------------------------

// independent MSMs (e.g. per-row vector-Pedersen commits), threaded across
// rows: ns[r] = length of row r; scalars/points are the rows concatenated.
void qq_pt_msm_many(u64 rows, const u64 *ns, const uint8_t *scalars,
                    const uint8_t *points, uint8_t *out) {
  std::vector<u64> off(rows + 1, 0);
  for (u64 r = 0; r < rows; r++) off[r + 1] = off[r] + ns[r];
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  unsigned nt = rows < hw ? (unsigned)rows : hw;
  if (nt <= 1) {
    for (u64 r = 0; r < rows; r++) {
      Pt res;
      msm_chunk(ns[r], scalars + 32 * off[r], points + 128 * off[r], &res);
      pt_store(out + 128 * r, &res);
    }
    return;
  }
  std::vector<std::thread> ths;
  for (unsigned t = 0; t < nt; t++) {
    ths.emplace_back([&, t]() {
      for (u64 r = t; r < rows; r += nt) {
        Pt res;
        msm_chunk(ns[r], scalars + 32 * off[r], points + 128 * off[r], &res);
        pt_store(out + 128 * r, &res);
      }
    });
  }
  for (auto &th : ths) th.join();
}

static void mul_batch_range(u64 lo, u64 hi, const uint8_t *scalars,
                            const uint8_t *points, uint8_t *out) {
  for (u64 i = lo; i < hi; i++) {
    Pt p, r;
    pt_load(&p, points + 128 * i);
    pt_scalar_mul(&r, scalars + 32 * i, &p);
    pt_store(out + 128 * i, &r);
  }
}

// out[i] = s_i * P_i
void qq_pt_mul_batch(u64 n, const uint8_t *scalars, const uint8_t *points,
                     uint8_t *out) {
  unsigned nt = pool_threads(n, 8);
  if (nt <= 1) { mul_batch_range(0, n, scalars, points, out); return; }
  std::vector<std::thread> ths;
  u64 per = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    u64 lo = per * t, hi = lo + per < n ? lo + per : n;
    ths.emplace_back(mul_batch_range, lo, hi, scalars, points, out);
  }
  for (auto &th : ths) th.join();
}

// Strauss shared-doubling double-scalar mul: r = a*P + b*Q
static void pt_double_scalar_mul(Pt *r, const uint8_t *a, const Pt *p,
                                 const uint8_t *b, const Pt *q) {
  Pt tp[16], tq[16];
  pt_identity(&tp[0]);
  pt_identity(&tq[0]);
  tp[1] = *p;
  tq[1] = *q;
  for (int k = 2; k < 16; k++) {
    if (k % 2 == 0) {
      pt_double(&tp[k], &tp[k / 2]);
      pt_double(&tq[k], &tq[k / 2]);
    } else {
      pt_add(&tp[k], &tp[k - 1], p);
      pt_add(&tq[k], &tq[k - 1], q);
    }
  }
  pt_identity(r);
  int started = 0;
  for (int i = 31; i >= 0; i--) {
    for (int half = 1; half >= 0; half--) {
      int na = half ? (a[i] >> 4) : (a[i] & 15);
      int nb = half ? (b[i] >> 4) : (b[i] & 15);
      if (started) {
        pt_double(r, r); pt_double(r, r); pt_double(r, r); pt_double(r, r);
        if (na) pt_add(r, r, &tp[na]);
        if (nb) pt_add(r, r, &tq[nb]);
      } else if (na || nb) {
        if (na) { *r = tp[na]; if (nb) pt_add(r, r, &tq[nb]); }
        else *r = tq[nb];
        started = 1;
      }
    }
  }
}

static void fold_batch_range(u64 lo, u64 hi, const uint8_t *as,
                             const uint8_t *bs, const uint8_t *ps,
                             const uint8_t *qs, uint8_t *out) {
  for (u64 i = lo; i < hi; i++) {
    Pt p, q, r;
    pt_load(&p, ps + 128 * i);
    pt_load(&q, qs + 128 * i);
    pt_double_scalar_mul(&r, as + 32 * i, &p, bs + 32 * i, &q);
    pt_store(out + 128 * i, &r);
  }
}

// out[i] = a_i*P_i + b_i*Q_i  (the IPP generator-fold shape)
void qq_fold_batch(u64 n, const uint8_t *as, const uint8_t *bs,
                   const uint8_t *ps, const uint8_t *qs, uint8_t *out) {
  unsigned nt = pool_threads(n, 8);
  if (nt <= 1) { fold_batch_range(0, n, as, bs, ps, qs, out); return; }
  std::vector<std::thread> ths;
  u64 per = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    u64 lo = per * t, hi = lo + per < n ? lo + per : n;
    ths.emplace_back(fold_batch_range, lo, hi, as, bs, ps, qs, out);
  }
  for (auto &th : ths) th.join();
}

// batched ristretto encode/decode (threaded): one ctypes crossing for a
// whole proof's worth of compress/decompress work
void qq_ristretto_encode_batch(u64 n, const uint8_t *points, uint8_t *out) {
  auto range = [](u64 lo, u64 hi, const uint8_t *pts, uint8_t *o) {
    for (u64 i = lo; i < hi; i++) qq_ristretto_encode(pts + 128 * i, o + 32 * i);
  };
  unsigned nt = pool_threads(n, 16);
  if (nt <= 1) { range(0, n, points, out); return; }
  std::vector<std::thread> ths;
  u64 per = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    u64 lo = per * t, hi = lo + per < n ? lo + per : n;
    ths.emplace_back(range, lo, hi, points, out);
  }
  for (auto &th : ths) th.join();
}

// returns the index of the first invalid encoding, or -1 if all decode
long long qq_ristretto_decode_batch(u64 n, const uint8_t *in,
                                    uint8_t *points_out) {
  std::vector<long long> bad((size_t)pool_threads(n, 16), -1);
  auto range = [&bad](unsigned t, u64 lo, u64 hi, const uint8_t *b,
                      uint8_t *o) {
    for (u64 i = lo; i < hi; i++)
      if (!qq_ristretto_decode(b + 32 * i, o + 128 * i)) {
        bad[t] = (long long)i;
        return;
      }
  };
  unsigned nt = (unsigned)bad.size();
  if (nt <= 1) {
    range(0, 0, n, in, points_out);
    return bad[0];
  }
  std::vector<std::thread> ths;
  u64 per = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    u64 lo = per * t, hi = lo + per < n ? lo + per : n;
    ths.emplace_back(range, t, lo, hi, in, points_out);
  }
  for (auto &th : ths) th.join();
  long long first = -1;
  for (long long b : bad)
    if (b >= 0 && (first < 0 || b < first)) first = b;
  return first;
}

}  // extern "C"
