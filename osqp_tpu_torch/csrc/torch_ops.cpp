// The kernel entries of the traced programs as torch.library operators,
// namespace osqp_tpu_torch: the launches that the dense_inv solve and its
// polish make (K4 ruiz, K2 chol_inverse and its leaves, K1 admm_iter, K1r
// admm_iter_refined on both paths, K3 term_products, K8's factor from
// the KKT blocks and its solve), those of the sparse cg solve and its
// polish (K5's grouped products, its fused CG start and its scaling, K6's
// device loop), and those of the other dense backends (K7's factor and
// solve for block_tridiag, K6's dense loop for cg on dense operands, and
// K6's step, which the row-sharded operators' PCG takes).
//
// No kernel is new here.  Each operator calls the same extern "C" entry
// that the ctypes path calls (the wrappers in ops/), on PyTorch's current
// stream of the inputs' device, and allocates its outputs and scratch with
// at::empty, sized by the entries' own *_scratch queries.  The schemas are
// functional (inputs in, new outputs out), so that torch.export can trace
// a program through them, and each operator has a Meta kernel here, so
// that loading this library is all a reader of a saved program needs.
//
// Plans stay in Python (ops/ruiz.py:cluster_size, ops/admm_iter.py:
// refined_plan and resident_clusters, _build.split_geometry, the SM
// count): they come in as int arguments, and each is checked here
// against the card.  A plan that does not fit raises; no operator takes
// another path than the one it is given.  The settings (sigma, alpha,
// K8's shift, polish's divisor) come in as one-element tensors, as the
// program holds them (DynSettings): a float argument would make the
// tracer read a traced value on the host.
//
// Three launches carry state that a functional schema cannot.  K5's
// grouped launch takes a host table of raw pointers and job words
// (ops/ell.py:_launch_group): its operator takes the jobs as tensor and
// int lists and writes the same words here.  K6's loop writes x, r, z and
// p in place and counts instances in steps[B]: its operator writes copies
// of the start it is given and a counter it zeroes, and returns x and the
// steps (its dense loop computes its own start: its operator gives it a
// new x and a zeroed counter).  K6's step updates p, x, r, z and the steps in place and writes
// rz and r'r to the other slots of ping-pong pairs: its operator writes
// copies and returns all seven.
#include <cstdint>
#include <optional>
#include <tuple>
#include <vector>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/ones.h>
#include <ATen/ops/zeros.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

extern "C" {
int osqp_ruiz(int dtype, const void* P, const void* q, const void* A, const void* l, const void* u, void* c, void* D,
              void* E, void* Ps, void* qs, void* As, void* ls, void* us, void* col_a, void* row_a, void* col_p,
              void* p_col, int n_iters, int B, int n, int m, int rows_a, int rows_p, int cluster, void* stream);
int osqp_ruiz_resident_clusters(int dtype, int n, int m, int k);
void osqp_split_geometry(int B, int n, int m, int sm_count, int* out);
int osqp_chol_inverse(int dtype, const void* M, void* X, int B, int n, void* stream);
int osqp_chol_inverse_leaf(int dtype, const void* S, void* T, int B, int n, void* stream);
int osqp_chol_inverse_leaf_cluster(int dtype, const void* S, void* T, void* scratch, int B, int n, int k,
                                   void* stream);
long long osqp_chol_inverse_leaf_scratch(int n);
int osqp_chol_inverse_blocks_per_sm(int dtype, int n);
int osqp_admm_iter(int dtype, const void* Minv, const void* AMinvT, const void* A, const void* q, const void* l,
                   const void* u, const void* rho, const void* rho_inv, const void* active, const void* x,
                   const void* z, const void* y, const void* dx, const void* dy, void* x_out, void* z_out,
                   void* y_out, void* dx_out, void* dy_out, void* scratch, double sigma, double alpha, int B, int n,
                   int m, int sm_count, void* stream);
size_t osqp_admm_iter_scratch(int dtype, int B, int n, int m, int sm_count);
int osqp_admm_iter_refined(int dtype, const void* Minv, const void* A, const void* P, const void* q, const void* l,
                           const void* u, const void* rho, const void* rho_inv, const void* active, const void* x,
                           const void* z, const void* y, const void* dx, const void* dy, const void* y_lo,
                           void* x_out, void* z_out, void* y_out, void* dx_out, void* dy_out, void* y_lo_out,
                           void* scratch, double sigma, double alpha, int B, int n, int m, int sm_count,
                           void* stream);
size_t osqp_admm_iter_refined_scratch(int dtype, int B, int n, int m, int sm_count);
int osqp_admm_iter_refined_resident(int dtype, const void* Minv, const void* A, const void* P, const void* q,
                                    const void* l, const void* u, const void* rho, const void* rho_inv,
                                    const void* active, const void* x, const void* z, const void* y,
                                    const void* dx, const void* dy, const void* y_lo, void* x_out, void* z_out,
                                    void* y_out, void* dx_out, void* dy_out, void* y_lo_out, double sigma,
                                    double alpha, int B, int n, int m, int k, int p_res, int clusters,
                                    void* stream);
int osqp_admm_iter_refined_resident_clusters(int dtype, int n, int m, int k, int p_res);
int osqp_term_products(int dtype, const void* P, const void* A, const void* x, const void* y, const void* dx,
                       const void* dy, void* row_out, void* p_out, void* col_out, void* scratch, int B, int n, int m,
                       int rows_a, int rows_p, void* stream);
long long osqp_term_products_scratch(int dtype, int B, int n, int m, int rows_a, int rows_p, int nv);
int osqp_kkt_lu_factor_blocks(int dtype, const void* P, const void* A, const void* d, double shift, int n, int m,
                              void* lu, void* perm, void* scratch, int B, int sm_count, void* info, void* stream);
long long osqp_kkt_lu_factor_scratch(int dtype, int B, int N);
int osqp_kkt_lu_solve_scratch(int B, int N, int sm_count);
int osqp_kkt_lu_solve(int dtype, const void* lu, const void* perm, const void* b, void* x, void* scratch, int B,
                      int N, int sm_count, void* stream);
int osqp_ell_group(int dtype, const long long* words, int njobs, int B, int rows, int ipar, int run, int ctas,
                   void* stream);
int osqp_ell_cg_start(int dtype, const void* t_val, const void* t_idx, int kt, const void* rhs_x, const void* rhs_z,
                      const void* rho, const void* w, const void* Ax0, const void* Px0, const void* x0,
                      const void* dinv, double sigma, void* b, void* r, void* z, int B, int n, int m, int sm_count,
                      void* stream);
int osqp_ell_scale(int dtype, const void* val, const void* idx, const void* t_val, const void* t_idx,
                   const void* row_s, const void* col_s, const void* c, void* val_out, void* t_val_out, int B, int m,
                   int ka, int n, int kt, void* stream);
int osqp_cg_parts(int n);
int osqp_cg_loop(int dtype, const void* pv, const void* pi, int kp, const void* av, const void* ai, int ka,
                 const void* tv, const void* ti, int kt, const void* w, double sigma, double div, const void* dinv,
                 const void* tol2, const void* rz, const void* rr, void* x, void* r, void* z, void* p, void* Ap,
                 void* Mp, void* steps, int B, int n, int m, int max_iter, int cluster, int threads, int resident,
                 int vectors, int clusters, void* stream);
int osqp_cg_loop_smem(int dtype, int n, int m, int kp, int ka, int kt, int cluster, int resident, int vectors);
int osqp_cg_loop_clusters(int dtype, int cluster, int threads, int smem, int resident, int vectors);
int osqp_cg_dense_loop(int dtype, const void* P, const void* A, const void* w, double sigma, const void* dinv,
                       const void* b, const void* x0, const void* tol2, void* x, void* steps, void* scratch, int B,
                       int n, int m, int max_iter, int cluster, int threads, int resident, int vectors, int clusters,
                       void* stream);
int osqp_cg_dense_loop_smem(int dtype, int n, int m, int cluster, int resident, int vectors);
long long osqp_cg_dense_loop_scratch(int dtype, int n, int m, int cluster, int vectors, int clusters);
int osqp_cg_dense_loop_clusters(int dtype, int cluster, int threads, int smem, int resident, int vectors);
int osqp_cg_step(int dtype, void* p, const void* u, const void* v, const void* dinv, const void* tol2, const void* rz,
                 const void* rr, void* Mp, void* x, void* r, void* z, void* rz_next, void* rr_next, void* part,
                 void* steps, double sigma, int B, int n, void* stream);
int osqp_bt_factor(int dtype, const void* M, void* C, void* G, void* scratch, int B, int b, int Nb, int path,
                   int cluster, void* stream);
int osqp_bt_solve(int dtype, const void* C, const void* G, const void* rhs, void* x, void* scratch, int B, int b,
                  int Nb, int warps, void* stream);
long long osqp_bt_factor_scratch(int dtype, int b, int path);
long long osqp_bt_solve_scratch(int dtype, int b, int warps);
}

namespace {

using at::Tensor;
using OptTensor = std::optional<Tensor>;
using Five = std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor>;
using Six = std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor, Tensor>;
using Seven = std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor>;
using Eight = std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor>;

int code_of(const Tensor& t) {
  TORCH_CHECK(t.scalar_type() == at::kFloat || t.scalar_type() == at::kDouble,
              "osqp_tpu_torch: float32 or float64 tensors, not ", t.scalar_type());
  return t.scalar_type() == at::kFloat ? 0 : 1;
}

// Every tensor on x's CUDA device, contiguous; the floating ones of x's dtype.
void same(const char* op, const Tensor& x, std::initializer_list<const Tensor*> ts) {
  TORCH_CHECK(x.is_cuda(), op, ": CUDA tensors, not ", x.device());
  for (const Tensor* t : ts) {
    TORCH_CHECK(t->device() == x.device(), op, ": a tensor on ", t->device(), ", x on ", x.device());
    TORCH_CHECK(t->is_contiguous(), op, ": contiguous tensors");
    TORCH_CHECK(!t->is_floating_point() || t->scalar_type() == x.scalar_type(), op, ": a ", t->scalar_type(),
                " tensor beside ", x.scalar_type());
  }
}

void check(int code, const char* op) {
  TORCH_CHECK(code == 0, op, " kernel launch failed: CUDA error ", code, " (",
              cudaGetErrorString(static_cast<cudaError_t>(code)), ")");
}

int device_sms(const Tensor& t) {
  int sms = 0;
  check(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, t.get_device()), "cudaDeviceGetAttribute");
  return sms;
}

void check_sms(const char* op, const Tensor& t, int64_t sm_count) {
  TORCH_CHECK(sm_count == device_sms(t), op, ": planned for ", sm_count, " SMs, the card has ", device_sms(t));
}

void check_split(const char* op, const Tensor& t, int B, int n, int m, int64_t rows_a, int64_t rows_p) {
  int geo[3];
  osqp_split_geometry(B, n, m, device_sms(t), geo);
  TORCH_CHECK(rows_a == geo[1] && rows_p == geo[2], op, ": a split of ", rows_a, " / ", rows_p,
              " rows a block, the card's is ", geo[1], " / ", geo[2]);
}

// A setting (sigma, alpha, K8's shift) as the C entries take it: a
// one-element tensor, held on the host by the program that passes it (a
// runtime setting of DynSettings), read without a wait.
double scalar(const Tensor& t) {
  TORCH_CHECK(t.numel() == 1, "osqp_tpu_torch: a setting is a one-element tensor, not ", t.sizes());
  return t.item<double>();
}

void* stream_of(const Tensor& t) { return c10::cuda::getCurrentCUDAStream(t.get_device()).stream(); }

const void* cptr(const Tensor& t) { return t.data_ptr(); }
const void* cptr(const OptTensor& t) { return t.has_value() ? t->data_ptr() : nullptr; }
void* ptr(const Tensor& t) { return t.data_ptr(); }

Tensor bytes(const Tensor& like, int64_t n) { return at::empty({n}, like.options().dtype(at::kByte)); }

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------
Eight ruiz_meta(const Tensor& P, const Tensor& q, const Tensor& A, const Tensor& l, const Tensor& u, int64_t, int64_t,
                int64_t, int64_t) {
  const int64_t B = q.size(0), n = q.size(1), m = l.size(1);
  return {at::empty({B}, q.options()), at::empty({B, n}, q.options()), at::empty({B, m}, q.options()),
          at::empty_like(P), at::empty_like(q), at::empty_like(A), at::empty_like(l), at::empty_like(u)};
}

Eight ruiz_cuda(const Tensor& P, const Tensor& q, const Tensor& A, const Tensor& l, const Tensor& u, int64_t n_iters,
                int64_t cluster, int64_t rows_a, int64_t rows_p) {
  same("ruiz", q, {&P, &q, &A, &l, &u});
  c10::cuda::CUDAGuard guard(q.device());
  const int code = code_of(q), B = q.size(0), n = q.size(1), m = l.size(1);
  if (cluster > 0) {
    TORCH_CHECK(osqp_ruiz_resident_clusters(code, n, m, cluster) > 0, "ruiz: the card holds no cluster of ",
                cluster, " CTAs of the resident path at n = ", n, ", m = ", m);
  } else {
    check_split("ruiz", q, B, n, m, rows_a, rows_p);
  }
  Tensor c = at::ones({B}, q.options()), D = at::ones({B, n}, q.options()), E = at::ones({B, m}, q.options());
  Tensor Ps = at::empty_like(P), qs = at::empty_like(q), As = at::empty_like(A), ls = at::empty_like(l),
         us = at::empty_like(u);
  Tensor col_a, row_a, col_p, p_col;  // the split path's maxima (zero = +0.0) and P's column norm
  if (cluster == 0) {
    col_a = at::zeros({B, n}, q.options());
    col_p = at::zeros({B, n}, q.options());
    p_col = at::zeros({B, n}, q.options());
    row_a = at::zeros({B, m}, q.options());
  }
  auto opt = [](const Tensor& t) { return t.defined() ? t.data_ptr() : nullptr; };
  check(osqp_ruiz(code, cptr(P), cptr(q), cptr(A), cptr(l), cptr(u), ptr(c), ptr(D), ptr(E), ptr(Ps), ptr(qs),
                  ptr(As), ptr(ls), ptr(us), opt(col_a), opt(row_a), opt(col_p), opt(p_col), n_iters, B, n, m,
                  rows_a, rows_p, cluster, stream_of(q)),
        "ruiz");
  return {c, D, E, Ps, qs, As, ls, us};
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------
Tensor square_meta(const Tensor& M) { return at::empty_like(M); }
Tensor square_cluster_meta(const Tensor& S, int64_t) { return at::empty_like(S); }

Tensor chol_inverse_cuda(const Tensor& M) {
  same("chol_inverse", M, {&M});
  c10::cuda::CUDAGuard guard(M.device());
  const int code = code_of(M), B = M.size(0), n = M.size(1);
  TORCH_CHECK(osqp_chol_inverse_blocks_per_sm(code, n) > 0, "chol_inverse: no block of n = ", n, " fits an SM");
  Tensor X = at::empty_like(M);
  check(osqp_chol_inverse(code, cptr(M), ptr(X), B, n, stream_of(M)), "chol_inverse");
  return X;
}

Tensor chol_inverse_leaf_cuda(const Tensor& S) {
  same("chol_inverse_leaf", S, {&S});
  c10::cuda::CUDAGuard guard(S.device());
  const int code = code_of(S), B = S.size(0), n = S.size(1);
  TORCH_CHECK(osqp_chol_inverse_blocks_per_sm(code, n) > 0, "chol_inverse_leaf: no block of n = ", n,
              " fits an SM");
  Tensor T = at::empty_like(S);
  check(osqp_chol_inverse_leaf(code, cptr(S), ptr(T), B, n, stream_of(S)), "chol_inverse_leaf");
  return T;
}

Tensor chol_inverse_leaf_cluster_cuda(const Tensor& S, int64_t cluster) {
  same("chol_inverse_leaf_cluster", S, {&S});
  c10::cuda::CUDAGuard guard(S.device());
  const int code = code_of(S), B = S.size(0), n = S.size(1);
  TORCH_CHECK(cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16,
              "chol_inverse_leaf_cluster: clusters of 2, 4, 8 or 16 CTAs, not ", cluster);
  Tensor T = at::empty_like(S);
  // L's panel columns and the next diagonal block, published by their owners
  Tensor scratch = at::empty({B * osqp_chol_inverse_leaf_scratch(n)}, S.options());
  check(osqp_chol_inverse_leaf_cluster(code, cptr(S), ptr(T), ptr(scratch), B, n, cluster, stream_of(S)),
        "chol_inverse_leaf_cluster");
  return T;
}

// ---------------------------------------------------------------------------
// K1 and K1r
// ---------------------------------------------------------------------------
Five admm_iter_meta(const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor&,
                    const Tensor&, const Tensor&, const Tensor&, const Tensor& x, const Tensor& z, const Tensor& y,
                    const Tensor& dx, const Tensor& dy, const Tensor&, const Tensor&, int64_t) {
  return {at::empty_like(x), at::empty_like(z), at::empty_like(y), at::empty_like(dx), at::empty_like(dy)};
}

Five admm_iter_cuda(const Tensor& Minv, const Tensor& AMinvT, const Tensor& A, const Tensor& q, const Tensor& l,
                    const Tensor& u, const Tensor& rho, const Tensor& rho_inv, const Tensor& active, const Tensor& x,
                    const Tensor& z, const Tensor& y, const Tensor& dx, const Tensor& dy, const Tensor& sigma,
                    const Tensor& alpha, int64_t sm_count) {
  same("admm_iter", x, {&Minv, &AMinvT, &A, &q, &l, &u, &rho, &rho_inv, &active, &x, &z, &y, &dx, &dy});
  TORCH_CHECK(active.scalar_type() == at::kBool, "admm_iter: active must be bool");
  c10::cuda::CUDAGuard guard(x.device());
  check_sms("admm_iter", x, sm_count);
  const int code = code_of(x), B = x.size(0), n = x.size(1), m = z.size(1);
  Tensor xo = at::empty_like(x), zo = at::empty_like(z), yo = at::empty_like(y), dxo = at::empty_like(dx),
         dyo = at::empty_like(dy);
  Tensor ws = bytes(x, static_cast<int64_t>(osqp_admm_iter_scratch(code, B, n, m, sm_count)));
  check(osqp_admm_iter(code, cptr(Minv), cptr(AMinvT), cptr(A), cptr(q), cptr(l), cptr(u), cptr(rho), cptr(rho_inv),
                       cptr(active), cptr(x), cptr(z), cptr(y), cptr(dx), cptr(dy), ptr(xo), ptr(zo), ptr(yo),
                       ptr(dxo), ptr(dyo), ptr(ws), scalar(sigma), scalar(alpha), B, n, m, sm_count, stream_of(x)),
        "admm_iter");
  return {xo, zo, yo, dxo, dyo};
}

// The refined outputs; y_lo's is empty where the call has no carry.
Six refined_outputs(const Tensor& x, const Tensor& z, const Tensor& y, const Tensor& dx, const Tensor& dy,
                    const OptTensor& y_lo) {
  return {at::empty_like(x),  at::empty_like(z),  at::empty_like(y),
          at::empty_like(dx), at::empty_like(dy), y_lo.has_value() ? at::empty_like(*y_lo) : at::empty({0}, x.options())};
}

Six admm_iter_refined_meta(const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor&,
                           const Tensor&, const Tensor&, const Tensor&, const Tensor& x, const Tensor& z,
                           const Tensor& y, const Tensor& dx, const Tensor& dy, const OptTensor& y_lo, const Tensor&,
                           const Tensor&, int64_t) {
  return refined_outputs(x, z, y, dx, dy, y_lo);
}

Six admm_iter_refined_resident_meta(const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor&,
                                    const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor& x,
                                    const Tensor& z, const Tensor& y, const Tensor& dx, const Tensor& dy,
                                    const OptTensor& y_lo, const Tensor&, const Tensor&, int64_t, int64_t, int64_t) {
  return refined_outputs(x, z, y, dx, dy, y_lo);
}

void check_refined(const char* op, const Tensor& Minv, const Tensor& A, const Tensor& P, const Tensor& q,
                   const Tensor& l, const Tensor& u, const Tensor& rho, const Tensor& rho_inv, const Tensor& active,
                   const Tensor& x, const Tensor& z, const Tensor& y, const Tensor& dx, const Tensor& dy,
                   const OptTensor& y_lo) {
  same(op, x, {&Minv, &A, &P, &q, &l, &u, &rho, &rho_inv, &active, &x, &z, &y, &dx, &dy});
  if (y_lo.has_value()) same(op, x, {&*y_lo});
  TORCH_CHECK(active.scalar_type() == at::kBool, op, ": active must be bool");
}

Six admm_iter_refined_cuda(const Tensor& Minv, const Tensor& A, const Tensor& P, const Tensor& q, const Tensor& l,
                           const Tensor& u, const Tensor& rho, const Tensor& rho_inv, const Tensor& active,
                           const Tensor& x, const Tensor& z, const Tensor& y, const Tensor& dx, const Tensor& dy,
                           const OptTensor& y_lo, const Tensor& sigma, const Tensor& alpha, int64_t sm_count) {
  check_refined("admm_iter_refined", Minv, A, P, q, l, u, rho, rho_inv, active, x, z, y, dx, dy, y_lo);
  c10::cuda::CUDAGuard guard(x.device());
  check_sms("admm_iter_refined", x, sm_count);
  const int code = code_of(x), B = x.size(0), n = x.size(1), m = z.size(1);
  Six o = refined_outputs(x, z, y, dx, dy, y_lo);
  Tensor ws = bytes(x, static_cast<int64_t>(osqp_admm_iter_refined_scratch(code, B, n, m, sm_count)));
  check(osqp_admm_iter_refined(code, cptr(Minv), cptr(A), cptr(P), cptr(q), cptr(l), cptr(u), cptr(rho),
                               cptr(rho_inv), cptr(active), cptr(x), cptr(z), cptr(y), cptr(dx), cptr(dy), cptr(y_lo),
                               ptr(std::get<0>(o)), ptr(std::get<1>(o)), ptr(std::get<2>(o)), ptr(std::get<3>(o)),
                               ptr(std::get<4>(o)), y_lo.has_value() ? ptr(std::get<5>(o)) : nullptr, ptr(ws),
                               scalar(sigma), scalar(alpha), B, n, m, sm_count, stream_of(x)),
        "admm_iter_refined");
  return o;
}

Six admm_iter_refined_resident_cuda(const Tensor& Minv, const Tensor& A, const Tensor& P, const Tensor& q,
                                    const Tensor& l, const Tensor& u, const Tensor& rho, const Tensor& rho_inv,
                                    const Tensor& active, const Tensor& x, const Tensor& z, const Tensor& y,
                                    const Tensor& dx, const Tensor& dy, const OptTensor& y_lo, const Tensor& sigma,
                                    const Tensor& alpha, int64_t cluster, int64_t p_res, int64_t clusters) {
  check_refined("admm_iter_refined_resident", Minv, A, P, q, l, u, rho, rho_inv, active, x, z, y, dx, dy, y_lo);
  c10::cuda::CUDAGuard guard(x.device());
  const int code = code_of(x), B = x.size(0), n = x.size(1), m = z.size(1);
  TORCH_CHECK(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16,
              "admm_iter_refined_resident: clusters of 1, 2, 4, 8 or 16 CTAs, not ", cluster);
  const int held = osqp_admm_iter_refined_resident_clusters(code, n, m, cluster, p_res != 0);
  TORCH_CHECK(clusters > 0 && clusters == held, "admm_iter_refined_resident: planned for ", clusters,
              " clusters of ", cluster, " CTAs at once, the card holds ", held, " at n = ", n, ", m = ", m);
  Six o = refined_outputs(x, z, y, dx, dy, y_lo);
  check(osqp_admm_iter_refined_resident(code, cptr(Minv), cptr(A), cptr(P), cptr(q), cptr(l), cptr(u), cptr(rho),
                                        cptr(rho_inv), cptr(active), cptr(x), cptr(z), cptr(y), cptr(dx), cptr(dy),
                                        cptr(y_lo), ptr(std::get<0>(o)), ptr(std::get<1>(o)), ptr(std::get<2>(o)),
                                        ptr(std::get<3>(o)), ptr(std::get<4>(o)),
                                        y_lo.has_value() ? ptr(std::get<5>(o)) : nullptr, scalar(sigma), scalar(alpha),
                                        B, n, m, cluster, p_res != 0, clusters, stream_of(x)),
        "admm_iter_refined_resident");
  return o;
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------
// [A x, A dx] (k, B, m), [P x, P dx] (k, B, n), [A'y, A'dy] (k, B, n); k = 2
// with the certificate directions dx and dy, else 1.
std::tuple<Tensor, Tensor, Tensor> term_outputs(const Tensor& x, const Tensor& y, const OptTensor& dx) {
  const int64_t k = dx.has_value() ? 2 : 1, B = x.size(0), n = x.size(1), m = y.size(1);
  return {at::empty({k, B, m}, x.options()), at::empty({k, B, n}, x.options()), at::empty({k, B, n}, x.options())};
}

std::tuple<Tensor, Tensor, Tensor> term_products_meta(const Tensor&, const Tensor&, const Tensor& x, const Tensor& y,
                                                      const OptTensor& dx, const OptTensor&, int64_t, int64_t) {
  return term_outputs(x, y, dx);
}

std::tuple<Tensor, Tensor, Tensor> term_products_cuda(const Tensor& P, const Tensor& A, const Tensor& x,
                                                      const Tensor& y, const OptTensor& dx, const OptTensor& dy,
                                                      int64_t rows_a, int64_t rows_p) {
  same("term_products", x, {&P, &A, &x, &y});
  TORCH_CHECK(dx.has_value() == dy.has_value(), "term_products: both certificate directions dx and dy, or neither");
  if (dx.has_value()) same("term_products", x, {&*dx, &*dy});
  c10::cuda::CUDAGuard guard(x.device());
  const int code = code_of(x), B = x.size(0), n = x.size(1), m = y.size(1), k = dx.has_value() ? 2 : 1;
  check_split("term_products", x, B, n, m, rows_a, rows_p);
  auto o = term_outputs(x, y, dx);
  // The partial sums and the tickets, zeroed: every launch leaves them so.
  const int64_t nbytes = osqp_term_products_scratch(code, B, n, m, rows_a, rows_p, k);
  Tensor ws = nbytes ? at::zeros({nbytes}, x.options().dtype(at::kByte)) : Tensor();
  check(osqp_term_products(code, cptr(P), cptr(A), cptr(x), cptr(y), cptr(dx), cptr(dy), ptr(std::get<0>(o)),
                           ptr(std::get<1>(o)), ptr(std::get<2>(o)), nbytes ? ptr(ws) : nullptr, B, n, m, rows_a,
                           rows_p, stream_of(x)),
        "term_products");
  return o;
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------
std::tuple<Tensor, Tensor> kkt_factor_outputs(const Tensor& P, const Tensor& A) {
  const int64_t B = P.size(0), N = P.size(1) + A.size(1);
  return {at::empty({B, N, N}, P.options()), at::empty({B, N}, P.options().dtype(at::kInt))};
}

std::tuple<Tensor, Tensor> kkt_lu_factor_blocks_meta(const Tensor& P, const Tensor& A, const Tensor&, const Tensor&,
                                                     int64_t) {
  return kkt_factor_outputs(P, A);
}

std::tuple<Tensor, Tensor> kkt_lu_factor_blocks_cuda(const Tensor& P, const Tensor& A, const Tensor& d,
                                                     const Tensor& shift, int64_t sm_count) {
  same("kkt_lu_factor_blocks", P, {&P, &A, &d});
  c10::cuda::CUDAGuard guard(P.device());
  check_sms("kkt_lu_factor_blocks", P, sm_count);
  const int code = code_of(P), B = P.size(0), n = P.size(1), m = A.size(1);
  auto o = kkt_factor_outputs(P, A);
  Tensor scratch = bytes(P, osqp_kkt_lu_factor_scratch(code, B, n + m));
  int info[3];
  check(osqp_kkt_lu_factor_blocks(code, cptr(P), cptr(A), cptr(d), scalar(shift), n, m, ptr(std::get<0>(o)),
                                  ptr(std::get<1>(o)), ptr(scratch), B, sm_count, info, stream_of(P)),
        "kkt_lu_factor_blocks");
  return o;
}

Tensor kkt_lu_solve_meta(const Tensor&, const Tensor&, const Tensor& b, int64_t) { return at::empty_like(b); }

Tensor kkt_lu_solve_cuda(const Tensor& lu, const Tensor& perm, const Tensor& b, int64_t sm_count) {
  same("kkt_lu_solve", lu, {&lu, &perm, &b});
  TORCH_CHECK(perm.scalar_type() == at::kInt, "kkt_lu_solve: perm must be int32");
  c10::cuda::CUDAGuard guard(lu.device());
  check_sms("kkt_lu_solve", lu, sm_count);
  const int code = code_of(lu), B = lu.size(0), N = lu.size(1);
  Tensor x = at::empty_like(b);
  const int ints = osqp_kkt_lu_solve_scratch(B, N, sm_count);
  Tensor scratch = ints ? at::zeros({ints}, lu.options().dtype(at::kInt)) : Tensor();
  check(osqp_kkt_lu_solve(code, cptr(lu), cptr(perm), cptr(b), ptr(x), ints ? ptr(scratch) : nullptr, B, N, sm_count,
                          stream_of(lu)),
        "kkt_lu_solve");
  return x;
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------
using OptTensors = c10::List<std::optional<Tensor>>;
using Ints = c10::IntArrayRef;

constexpr int64_t kMaxJobs = 8;  // csrc/ell_ops.cu: kMaxJobs
constexpr int64_t kWSum = 1, kDiag = 4;  // the job modes: sum, weighted sum, squares, maxima, diagonal

std::vector<Tensor> ell_group_meta(at::TensorList vals, at::TensorList, const OptTensors&, const OptTensors&, Ints,
                                   Ints R, Ints, Ints, int64_t, int64_t, int64_t, int64_t, int64_t) {
  std::vector<Tensor> outs;
  for (size_t j = 0; j < R.size(); ++j) outs.push_back(at::empty({vals[0].size(0), R[j]}, vals[0].options()));
  return outs;
}

// Job j reduces vals[j] (B,R,k) over the pattern idxs[j] (R,k) int32,
// gathering gs[j] (B,G) (none for the diagonal) weighted by ws[j] (the
// weighted sum alone), in modes[j]; the plan (ops/ell.py:plan) cuts it
// into tiles[j] tiles of `rows` rows from CTA cta0[j] on, over runs of
// `run` instances.  The words are those ops/ell.py:_launch_group writes.
std::vector<Tensor> ell_group_cuda(at::TensorList vals, at::TensorList idxs, const OptTensors& gs, const OptTensors& ws,
                                   Ints modes, Ints R, Ints tiles, Ints cta0, int64_t rows, int64_t ipar, int64_t run,
                                   int64_t ctas, int64_t sm_count) {
  const int64_t nj = static_cast<int64_t>(vals.size());
  TORCH_CHECK(nj >= 1 && nj <= kMaxJobs, "ell_group: 1 to ", kMaxJobs, " jobs a launch, not ", nj);
  TORCH_CHECK(static_cast<int64_t>(idxs.size()) == nj && static_cast<int64_t>(gs.size()) == nj &&
                  static_cast<int64_t>(ws.size()) == nj && static_cast<int64_t>(modes.size()) == nj &&
                  static_cast<int64_t>(R.size()) == nj && static_cast<int64_t>(tiles.size()) == nj &&
                  static_cast<int64_t>(cta0.size()) == nj,
              "ell_group: every list holds one entry a job");
  const Tensor& x = vals[0];
  TORCH_CHECK(x.is_cuda(), "ell_group: CUDA tensors, not ", x.device());
  c10::cuda::CUDAGuard guard(x.device());
  check_sms("ell_group", x, sm_count);
  const int code = code_of(x);
  const int64_t B = x.size(0);
  TORCH_CHECK(rows >= 1 && ipar >= 1 && run >= ipar && run % ipar == 0, "ell_group: a plan of ", rows, " rows, ",
              ipar, " instances side by side and runs of ", run);
  const int64_t runs = (B + run - 1) / run;
  std::vector<long long> words;
  std::vector<Tensor> outs;
  int64_t next = 0;
  for (int64_t j = 0; j < nj; ++j) {
    const Tensor& val = vals[j];
    const Tensor& idx = idxs[j];
    same("ell_group", x, {&val, &idx});
    TORCH_CHECK(idx.scalar_type() == at::kInt, "ell_group: the pattern must be int32");
    TORCH_CHECK(val.dim() == 3 && idx.dim() == 2 && val.size(0) == B && val.size(1) == idx.size(0) &&
                    val.size(2) == idx.size(1) && val.size(1) == R[j],
                "ell_group: job ", j, "'s values ", val.sizes(), " do not fit its pattern ", idx.sizes(), " and ",
                R[j], " rows");
    TORCH_CHECK(modes[j] >= 0 && modes[j] <= kDiag, "ell_group: mode ", modes[j]);
    TORCH_CHECK(tiles[j] >= 1 && tiles[j] * rows >= R[j] && (tiles[j] - 1) * rows < R[j] && cta0[j] == next,
                "ell_group: job ", j, "'s tiles do not follow the plan");
    next += tiles[j] * runs;
    const std::optional<Tensor> g = gs.get(j), w = ws.get(j);
    TORCH_CHECK(g.has_value() == (modes[j] != kDiag) && w.has_value() == (modes[j] == kWSum),
                "ell_group: job ", j, " of mode ", modes[j], " takes ", modes[j] == kDiag ? "no vector" : "a vector",
                modes[j] == kWSum ? " and weights" : "");
    int64_t G = 0;
    if (g.has_value()) {
      same("ell_group", x, {&*g});
      TORCH_CHECK(g->dim() == 2 && g->size(0) == B, "ell_group: job ", j, "'s vector is ", g->sizes());
      G = g->size(1);
      if (w.has_value()) {
        same("ell_group", x, {&*w});
        TORCH_CHECK(w->sizes() == g->sizes(), "ell_group: job ", j, "'s weights are ", w->sizes());
      }
    }
    Tensor out = at::empty({B, R[j]}, x.options());
    const long long word[] = {reinterpret_cast<long long>(val.data_ptr()),
                              reinterpret_cast<long long>(idx.data_ptr()),
                              g.has_value() ? reinterpret_cast<long long>(g->data_ptr()) : 0,
                              w.has_value() ? reinterpret_cast<long long>(w->data_ptr()) : 0,
                              reinterpret_cast<long long>(out.data_ptr()),
                              R[j], idx.size(1), G, modes[j], tiles[j], cta0[j]};
    words.insert(words.end(), std::begin(word), std::end(word));
    outs.push_back(out);
  }
  TORCH_CHECK(next == ctas, "ell_group: the plan's ", ctas, " CTAs, its jobs' ", next);
  if (B > 0)
    check(osqp_ell_group(code, words.data(), static_cast<int>(nj), B, rows, ipar, run, ctas, stream_of(x)),
          "ell_group");
  return outs;
}

// b (with rhs_z; else an empty tensor: b is rhs_x), r and z.
std::tuple<Tensor, Tensor, Tensor> cg_start_outputs(const Tensor& x0, const OptTensor& rhs_z) {
  return {rhs_z.has_value() ? at::empty_like(x0) : at::empty({0}, x0.options()), at::empty_like(x0),
          at::empty_like(x0)};
}

std::tuple<Tensor, Tensor, Tensor> ell_cg_start_meta(const Tensor&, const Tensor&, const Tensor&,
                                                     const OptTensor& rhs_z, const OptTensor&, const Tensor&,
                                                     const Tensor&, const Tensor&, const Tensor& x0, const Tensor&,
                                                     const Tensor&, int64_t) {
  return cg_start_outputs(x0, rhs_z);
}

std::tuple<Tensor, Tensor, Tensor> ell_cg_start_cuda(const Tensor& t_val, const Tensor& t_idx, const Tensor& rhs_x,
                                                     const OptTensor& rhs_z, const OptTensor& rho, const Tensor& w,
                                                     const Tensor& Ax0, const Tensor& Px0, const Tensor& x0,
                                                     const Tensor& dinv, const Tensor& sigma, int64_t sm_count) {
  same("ell_cg_start", x0, {&t_val, &t_idx, &rhs_x, &w, &Ax0, &Px0, &x0, &dinv});
  TORCH_CHECK(rhs_z.has_value() == rho.has_value(), "ell_cg_start: rhs_z and rho together");
  if (rhs_z.has_value()) same("ell_cg_start", x0, {&*rhs_z, &*rho});
  TORCH_CHECK(t_idx.scalar_type() == at::kInt, "ell_cg_start: the pattern must be int32");
  c10::cuda::CUDAGuard guard(x0.device());
  check_sms("ell_cg_start", x0, sm_count);
  const int code = code_of(x0), B = x0.size(0), n = x0.size(1), m = w.size(1);
  TORCH_CHECK(t_val.dim() == 3 && t_val.size(0) == B && t_val.size(1) == n && t_idx.size(0) == n &&
                  t_val.size(2) == t_idx.size(1) && Ax0.size(1) == m && m >= 1,
              "ell_cg_start: the transpose ", t_val.sizes(), " does not fit x0 ", x0.sizes(), " and w ", w.sizes());
  auto o = cg_start_outputs(x0, rhs_z);
  check(osqp_ell_cg_start(code, cptr(t_val), cptr(t_idx), t_idx.size(1), cptr(rhs_x), cptr(rhs_z), cptr(rho),
                          cptr(w), cptr(Ax0), cptr(Px0), cptr(x0), cptr(dinv), scalar(sigma),
                          rhs_z.has_value() ? ptr(std::get<0>(o)) : nullptr, ptr(std::get<1>(o)),
                          ptr(std::get<2>(o)), B, n, m, sm_count, stream_of(x0)),
        "ell_cg_start");
  return o;
}

std::tuple<Tensor, Tensor> ell_scale_meta(const Tensor& val, const Tensor&, const Tensor& t_val, const Tensor&,
                                          const Tensor&, const Tensor&, const OptTensor&) {
  return {at::empty_like(val), at::empty_like(t_val)};
}

std::tuple<Tensor, Tensor> ell_scale_cuda(const Tensor& val, const Tensor& idx, const Tensor& t_val,
                                          const Tensor& t_idx, const Tensor& row_s, const Tensor& col_s,
                                          const OptTensor& c) {
  same("ell_scale", val, {&val, &idx, &t_val, &t_idx, &row_s, &col_s});
  if (c.has_value()) same("ell_scale", val, {&*c});
  TORCH_CHECK(idx.scalar_type() == at::kInt && t_idx.scalar_type() == at::kInt, "ell_scale: int32 patterns");
  c10::cuda::CUDAGuard guard(val.device());
  const int code = code_of(val), B = val.size(0), m = val.size(1), ka = val.size(2), n = t_val.size(1),
            kt = t_val.size(2);
  TORCH_CHECK(t_val.size(0) == B && idx.size(0) == m && idx.size(1) == ka && t_idx.size(0) == n &&
                  t_idx.size(1) == kt && row_s.sizes() == at::IntArrayRef({B, m}) &&
                  col_s.sizes() == at::IntArrayRef({B, n}) && (!c.has_value() || c->numel() == B),
              "ell_scale: values ", val.sizes(), " / ", t_val.sizes(), " and scales ", row_s.sizes(), " / ",
              col_s.sizes(), " disagree");
  Tensor vo = at::empty_like(val), tvo = at::empty_like(t_val);
  if (m > 0 && n > 0)
    check(osqp_ell_scale(code, cptr(val), cptr(idx), cptr(t_val), cptr(t_idx), cptr(row_s), cptr(col_s), cptr(c),
                         ptr(vo), ptr(tvo), B, m, ka, n, kt, stream_of(val)),
          "ell_scale");
  else {
    vo.zero_();
    tvo.zero_();
  }
  return {vo, tvo};
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------
std::tuple<Tensor, Tensor> cg_loop_meta(const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor&,
                                        const Tensor&, const OptTensor&, const Tensor&, const OptTensor&,
                                        const Tensor&, const Tensor&, const Tensor&, const Tensor&, const Tensor& x,
                                        const Tensor&, const Tensor&, const Tensor&, int64_t, int64_t, int64_t,
                                        int64_t, int64_t, int64_t) {
  return {at::empty_like(x), at::empty({x.size(0)}, x.options().dtype(at::kInt))};
}

// The whole CG solve of every instance from the start (x, r, z, p, rz,
// rr) in one launch of the loop, on the plan (ops/cg.py:loop_plan) it is
// given: clusters of `cluster` CTAs of `threads` threads, the operands'
// rows and the vectors in shared memory as `resident` and `vectors` say,
// `clusters` clusters at once, which the card must hold.  The cg form
// with the weights w, polish's with the divisor div.
std::tuple<Tensor, Tensor> cg_loop_cuda(const Tensor& pv, const Tensor& pi, const Tensor& av, const Tensor& ai,
                                        const Tensor& tv, const Tensor& ti, const OptTensor& w, const Tensor& sigma,
                                        const OptTensor& div, const Tensor& dinv, const Tensor& tol2, const Tensor& rz,
                                        const Tensor& rr, const Tensor& x, const Tensor& r, const Tensor& z,
                                        const Tensor& p, int64_t max_iter, int64_t cluster, int64_t threads,
                                        int64_t resident, int64_t vectors, int64_t clusters) {
  same("cg_loop", x, {&pv, &pi, &av, &ai, &tv, &ti, &dinv, &tol2, &rz, &rr, &x, &r, &z, &p});
  TORCH_CHECK(w.has_value() != div.has_value(), "cg_loop: exactly one of w (the cg form) and div (polish's form)");
  if (w.has_value()) same("cg_loop", x, {&*w});
  TORCH_CHECK(pi.scalar_type() == at::kInt && ai.scalar_type() == at::kInt && ti.scalar_type() == at::kInt,
              "cg_loop: int32 patterns");
  c10::cuda::CUDAGuard guard(x.device());
  const int code = code_of(x), B = x.size(0), n = x.size(1), m = av.size(1);
  const int kp = pi.size(1), ka = ai.size(1), kt = ti.size(1);
  TORCH_CHECK(pv.size(0) == B && pv.size(1) == n && av.size(0) == B && tv.size(0) == B && tv.size(1) == n &&
                  (!w.has_value() || w->sizes() == at::IntArrayRef({B, m})),
              "cg_loop: operands P ", pv.sizes(), ", A ", av.sizes(), ", A' ", tv.sizes(), " and x ", x.sizes(),
              " disagree");
  Tensor xo = x.clone(), steps = at::zeros({B + 1}, x.options().dtype(at::kInt));
  if (B == 0 || n == 0 || max_iter <= 0) return {xo, steps.narrow(0, 0, B)};
  TORCH_CHECK(cluster >= 1 && cluster <= osqp_cg_parts(n), "cg_loop: clusters of ", cluster, " CTAs at n = ", n);
  TORCH_CHECK(threads == 256 || threads == 512 || threads == 768 || threads == 1024, "cg_loop: CTAs of ", threads,
              " threads");
  const int smem = osqp_cg_loop_smem(code, n, m, kp, ka, kt, cluster, resident, vectors);
  const int held = osqp_cg_loop_clusters(code, cluster, threads, smem, resident, vectors);
  TORCH_CHECK(clusters >= 1 && clusters <= held, "cg_loop: planned for ", clusters, " clusters of ", cluster,
              " CTAs at once, the card holds ", held);
  Tensor ro = r.clone(), zo = z.clone(), po = p.clone(), Ap = at::empty({B, m}, x.options()), Mp = at::empty_like(x);
  check(osqp_cg_loop(code, cptr(pv), cptr(pi), kp, cptr(av), cptr(ai), ka, cptr(tv), cptr(ti), kt, cptr(w),
                     scalar(sigma), div.has_value() ? scalar(*div) : 0.0, cptr(dinv), cptr(tol2), cptr(rz), cptr(rr),
                     ptr(xo), ptr(ro), ptr(zo), ptr(po), ptr(Ap), ptr(Mp), ptr(steps), B, n, m, max_iter, cluster,
                     threads, resident, vectors, clusters, stream_of(x)),
        "cg_loop");
  return {xo, steps.narrow(0, 0, B)};
}

std::tuple<Tensor, Tensor> cg_dense_loop_meta(const Tensor&, const Tensor&, const Tensor&, const Tensor&,
                                              const Tensor&, const Tensor& b, const OptTensor&, const Tensor&,
                                              int64_t, int64_t, int64_t, int64_t, int64_t, int64_t) {
  return {at::empty_like(b), at::empty({b.size(0)}, b.options().dtype(at::kInt))};
}

// The whole CG solve of every instance on dense operands in one launch of
// the dense loop, from x0 (zeros where absent), its start included, on
// the plan (ops/cg.py:dense_loop_plan) it is given: clusters of `cluster`
// CTAs of `threads` threads, the rows of P and A and the vectors in
// shared memory as `resident` and `vectors` say, `clusters` clusters at
// once, which the card must hold.  tol2: the squared tolerances.
std::tuple<Tensor, Tensor> cg_dense_loop_cuda(const Tensor& P, const Tensor& A, const Tensor& w, const Tensor& sigma,
                                              const Tensor& dinv, const Tensor& b, const OptTensor& x0,
                                              const Tensor& tol2, int64_t max_iter, int64_t cluster, int64_t threads,
                                              int64_t resident, int64_t vectors, int64_t clusters) {
  same("cg_dense_loop", b, {&P, &A, &w, &dinv, &b, &tol2});
  if (x0.has_value()) same("cg_dense_loop", b, {&*x0});
  c10::cuda::CUDAGuard guard(b.device());
  const int code = code_of(b), B = b.size(0), n = b.size(1), m = A.size(1);
  TORCH_CHECK(P.sizes() == at::IntArrayRef({B, n, n}) && A.sizes() == at::IntArrayRef({B, m, n}) &&
                  w.sizes() == at::IntArrayRef({B, m}) && dinv.sizes() == b.sizes() &&
                  tol2.sizes() == at::IntArrayRef({B}) && (!x0.has_value() || x0->sizes() == b.sizes()),
              "cg_dense_loop: P ", P.sizes(), ", A ", A.sizes(), ", w ", w.sizes(), " and b ", b.sizes(), " disagree");
  Tensor steps = at::zeros({B + 1}, b.options().dtype(at::kInt));
  if (B == 0 || n == 0 || max_iter <= 0)
    return {x0.has_value() ? x0->clone() : at::zeros(b.sizes(), b.options()), steps.narrow(0, 0, B)};
  TORCH_CHECK(cluster >= 1 && cluster <= 16 && (cluster & (cluster - 1)) == 0, "cg_dense_loop: clusters of ",
              cluster, " CTAs (a power of two up to 16)");
  TORCH_CHECK(threads == 256 || threads == 512 || threads == 768, "cg_dense_loop: CTAs of ", threads, " threads");
  const int smem = osqp_cg_dense_loop_smem(code, n, m, cluster, resident, vectors);
  const int held = osqp_cg_dense_loop_clusters(code, cluster, threads, smem, resident, vectors);
  TORCH_CHECK(clusters >= 1 && clusters <= held, "cg_dense_loop: planned for ", clusters, " clusters of ", cluster,
              " CTAs at once, the card holds ", held);
  const int at_once = clusters < B ? clusters : B;
  Tensor x = at::empty_like(b), scratch = bytes(b, osqp_cg_dense_loop_scratch(code, n, m, cluster, vectors, at_once));
  check(osqp_cg_dense_loop(code, cptr(P), cptr(A), cptr(w), scalar(sigma), cptr(dinv), cptr(b), cptr(x0), cptr(tol2),
                           ptr(x), ptr(steps), ptr(scratch), B, n, m, max_iter, cluster, threads, resident, vectors,
                           at_once, stream_of(b)),
        "cg_dense_loop");
  return {x, steps.narrow(0, 0, B)};
}

// One step's vector work (the three step kernels) from the direction p
// and its products u = P p and v = A'(rho A p) (none without rows of A):
// the new p, x, r, z, rz, r'r and steps, in copies of the inputs, as the
// ctypes launch writes them in place (ops/cg.py:cg_step).
Seven cg_step_meta(const Tensor& p, const Tensor&, const OptTensor&, const Tensor&, const Tensor&, const Tensor& rz,
                   const Tensor& rr, const Tensor& x, const Tensor& r, const Tensor& z, const Tensor& steps,
                   const Tensor&) {
  return {at::empty_like(p), at::empty_like(x), at::empty_like(r), at::empty_like(z), at::empty_like(rz),
          at::empty_like(rr), at::empty_like(steps)};
}

Seven cg_step_cuda(const Tensor& p, const Tensor& u, const OptTensor& v, const Tensor& dinv, const Tensor& tol2,
                   const Tensor& rz, const Tensor& rr, const Tensor& x, const Tensor& r, const Tensor& z,
                   const Tensor& steps, const Tensor& sigma) {
  same("cg_step", p, {&p, &u, &dinv, &tol2, &rz, &rr, &x, &r, &z, &steps});
  if (v.has_value()) same("cg_step", p, {&*v});
  TORCH_CHECK(steps.scalar_type() == at::kInt, "cg_step: steps must be int32");
  c10::cuda::CUDAGuard guard(p.device());
  const int code = code_of(p), B = p.size(0), n = p.size(1);
  TORCH_CHECK(u.sizes() == p.sizes() && (!v.has_value() || v->sizes() == p.sizes()) && dinv.sizes() == p.sizes() &&
                  x.sizes() == p.sizes() && r.sizes() == p.sizes() && z.sizes() == p.sizes() &&
                  rz.sizes() == at::IntArrayRef({B}) && rr.sizes() == at::IntArrayRef({B}) &&
                  tol2.sizes() == at::IntArrayRef({B}) && steps.sizes() == at::IntArrayRef({B}),
              "cg_step: vectors ", p.sizes(), " and ", u.sizes(), ", scalars ", rz.sizes(), " disagree");
  if (B == 0 || n == 0) return {p.clone(), x.clone(), r.clone(), z.clone(), rz.clone(), rr.clone(), steps.clone()};
  // The launch updates p, x, r and steps in place and writes every entry
  // of z: the first four start as copies (plain device copies, with no
  // operator dispatched a copy), z's as new memory.
  void* stream = stream_of(p);
  auto copy = [stream](const Tensor& t) {
    Tensor o = at::empty_like(t);
    check(cudaMemcpyAsync(o.data_ptr(), t.data_ptr(), t.nbytes(), cudaMemcpyDeviceToDevice,
                          static_cast<cudaStream_t>(stream)),
          "cg_step copy");
    return o;
  };
  Tensor po = copy(p), xo = copy(x), ro = copy(r), so = copy(steps), zo = at::empty_like(z);
  Tensor rzo = at::empty_like(rz), rro = at::empty_like(rr);
  Tensor Mp = at::empty_like(p), parts = at::empty({3, B, osqp_cg_parts(n)}, p.options());
  check(osqp_cg_step(code, ptr(po), cptr(u), cptr(v), cptr(dinv), cptr(tol2), cptr(rz), cptr(rr), ptr(Mp), ptr(xo),
                     ptr(ro), ptr(zo), ptr(rzo), ptr(rro), ptr(parts), ptr(so), scalar(sigma), B, n, stream),
        "cg_step");
  return {po, xo, ro, zo, rzo, rro, so};
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------
// (C (B, Nb, b, b), G (B, Nb-1, b, b)) of M (B, Nb b, Nb b); G is (B, 0, b,
// b) at Nb = 1.
std::tuple<Tensor, Tensor> bt_factor_outputs(const Tensor& M, int64_t b) {
  const int64_t B = M.size(0), Nb = M.size(1) / b;
  return {at::empty({B, Nb, b, b}, M.options()), at::empty({B, Nb - 1, b, b}, M.options())};
}

void check_block(const char* op, const Tensor& M, int64_t b) {
  TORCH_CHECK(M.dim() == 3 && M.size(1) == M.size(2) && M.size(1) > 0 && b > 0 && M.size(1) % b == 0, op,
              ": a (B, n, n) batch with a block size dividing n, not ", M.sizes(), " and b = ", b);
}

std::tuple<Tensor, Tensor> bt_factor_meta(const Tensor& M, int64_t b, int64_t, int64_t) {
  check_block("bt_factor", M, b);
  return bt_factor_outputs(M, b);
}

// The factor on the path (0 warp, 1 cluster, 2 device) and in clusters of
// `cluster` CTAs that ops/block_tridiag.py (factor_path, cluster_plan,
// device_plan) names; the entry refuses a path that does not take b and
// a cluster whose strips miss shared memory.  The device path's scratch
// where its band misses shared memory (device_scratch).
std::tuple<Tensor, Tensor> bt_factor_cuda(const Tensor& M, int64_t b, int64_t path, int64_t cluster) {
  same("bt_factor", M, {&M});
  check_block("bt_factor", M, b);
  TORCH_CHECK((path == 0 && cluster == 0 && b <= 32) ||
                  ((path == 1 || path == 2) && (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
                                                cluster == 16)),
              "bt_factor: no path ", path, " with clusters of ", cluster, " CTAs at b = ", b);
  c10::cuda::CUDAGuard guard(M.device());
  const int code = code_of(M), B = M.size(0), Nb = M.size(1) / b;
  auto o = bt_factor_outputs(M, b);
  const long long spill = osqp_bt_factor_scratch(code, b, path);
  Tensor scratch = spill ? at::empty({B * cluster * spill}, M.options()) : Tensor();
  check(osqp_bt_factor(code, cptr(M), ptr(std::get<0>(o)), ptr(std::get<1>(o)), spill ? ptr(scratch) : nullptr, B,
                       b, Nb, path, cluster, stream_of(M)),
        "bt_factor");
  return o;
}

Tensor bt_solve_meta(const Tensor&, const Tensor&, const Tensor& r, int64_t) { return at::empty_like(r); }

// x = M^-1 r in the layout ops/block_tridiag.py:solve_plan names: 0 warps
// the warp path (b <= 32), else the wide solve in CTAs of that many warps,
// with the scratch of solve_scratch where its vectors miss shared memory.
Tensor bt_solve_cuda(const Tensor& C, const Tensor& G, const Tensor& r, int64_t warps) {
  same("bt_solve", C, {&C, &G, &r});
  TORCH_CHECK(C.dim() == 4 && C.size(2) == C.size(3) && C.size(1) > 0 && C.size(2) > 0, "bt_solve: C is ",
              C.sizes());
  const int64_t B = C.size(0), Nb = C.size(1), b = C.size(2);
  TORCH_CHECK(G.sizes() == at::IntArrayRef({B, Nb - 1, b, b}) && r.sizes() == at::IntArrayRef({B, Nb * b}),
              "bt_solve: G ", G.sizes(), " and r ", r.sizes(), " do not fit C ", C.sizes());
  TORCH_CHECK((warps == 0 && b <= 32) || (warps >= 2 && warps <= 12 && b > 32), "bt_solve: no layout of ", warps,
              " warps at b = ", b);
  c10::cuda::CUDAGuard guard(C.device());
  const int code = code_of(C);
  Tensor x = at::empty_like(r);
  const long long spill = osqp_bt_solve_scratch(code, b, warps);
  Tensor scratch = spill ? at::empty({B * spill}, C.options()) : Tensor();
  check(osqp_bt_solve(code, cptr(C), cptr(G), cptr(r), ptr(x), spill ? ptr(scratch) : nullptr, B, b, Nb, warps,
                      stream_of(C)),
        "bt_solve");
  return x;
}

}  // namespace

TORCH_LIBRARY(osqp_tpu_torch, m) {
  m.def("ruiz(Tensor P, Tensor q, Tensor A, Tensor l, Tensor u, int n_iters, int cluster, int rows_a, int rows_p)"
        " -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("chol_inverse(Tensor M) -> Tensor");
  m.def("chol_inverse_leaf(Tensor S) -> Tensor");
  m.def("chol_inverse_leaf_cluster(Tensor S, int cluster) -> Tensor");
  m.def("admm_iter(Tensor Minv, Tensor AMinvT, Tensor A, Tensor q, Tensor l, Tensor u, Tensor rho, Tensor rho_inv,"
        " Tensor active, Tensor x, Tensor z, Tensor y, Tensor dx, Tensor dy, Tensor sigma, Tensor alpha, int sm_count)"
        " -> (Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("admm_iter_refined(Tensor Minv, Tensor A, Tensor P, Tensor q, Tensor l, Tensor u, Tensor rho,"
        " Tensor rho_inv, Tensor active, Tensor x, Tensor z, Tensor y, Tensor dx, Tensor dy, Tensor? y_lo,"
        " Tensor sigma, Tensor alpha, int sm_count) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("admm_iter_refined_resident(Tensor Minv, Tensor A, Tensor P, Tensor q, Tensor l, Tensor u, Tensor rho,"
        " Tensor rho_inv, Tensor active, Tensor x, Tensor z, Tensor y, Tensor dx, Tensor dy, Tensor? y_lo,"
        " Tensor sigma, Tensor alpha, int cluster, int p_res, int clusters)"
        " -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("term_products(Tensor P, Tensor A, Tensor x, Tensor y, Tensor? dx, Tensor? dy, int rows_a, int rows_p)"
        " -> (Tensor, Tensor, Tensor)");
  m.def("kkt_lu_factor_blocks(Tensor P, Tensor A, Tensor d, Tensor shift, int sm_count) -> (Tensor, Tensor)");
  m.def("kkt_lu_solve(Tensor lu, Tensor perm, Tensor b, int sm_count) -> Tensor");
  m.def("ell_group(Tensor[] vals, Tensor[] idxs, Tensor?[] gs, Tensor?[] ws, int[] modes, int[] R, int[] tiles,"
        " int[] cta0, int rows, int ipar, int run, int ctas, int sm_count) -> Tensor[]");
  m.def("ell_cg_start(Tensor t_val, Tensor t_idx, Tensor rhs_x, Tensor? rhs_z, Tensor? rho, Tensor w, Tensor Ax0,"
        " Tensor Px0, Tensor x0, Tensor dinv, Tensor sigma, int sm_count) -> (Tensor, Tensor, Tensor)");
  m.def("ell_scale(Tensor val, Tensor idx, Tensor t_val, Tensor t_idx, Tensor row_s, Tensor col_s, Tensor? c)"
        " -> (Tensor, Tensor)");
  m.def("cg_loop(Tensor pv, Tensor pi, Tensor av, Tensor ai, Tensor tv, Tensor ti, Tensor? w, Tensor sigma,"
        " Tensor? div, Tensor dinv, Tensor tol2, Tensor rz, Tensor rr, Tensor x, Tensor r, Tensor z, Tensor p,"
        " int max_iter, int cluster, int threads, int resident, int vectors, int clusters) -> (Tensor, Tensor)");
  m.def("cg_dense_loop(Tensor P, Tensor A, Tensor w, Tensor sigma, Tensor dinv, Tensor b, Tensor? x0, Tensor tol2,"
        " int max_iter, int cluster, int threads, int resident, int vectors, int clusters) -> (Tensor, Tensor)");
  m.def("cg_step(Tensor p, Tensor u, Tensor? v, Tensor dinv, Tensor tol2, Tensor rz, Tensor rr, Tensor x, Tensor r,"
        " Tensor z, Tensor steps, Tensor sigma) -> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("bt_factor(Tensor M, int b, int path, int cluster) -> (Tensor, Tensor)");
  m.def("bt_solve(Tensor C, Tensor G, Tensor r, int warps) -> Tensor");
}

TORCH_LIBRARY_IMPL(osqp_tpu_torch, CUDA, m) {
  m.impl("ruiz", &ruiz_cuda);
  m.impl("chol_inverse", &chol_inverse_cuda);
  m.impl("chol_inverse_leaf", &chol_inverse_leaf_cuda);
  m.impl("chol_inverse_leaf_cluster", &chol_inverse_leaf_cluster_cuda);
  m.impl("admm_iter", &admm_iter_cuda);
  m.impl("admm_iter_refined", &admm_iter_refined_cuda);
  m.impl("admm_iter_refined_resident", &admm_iter_refined_resident_cuda);
  m.impl("term_products", &term_products_cuda);
  m.impl("kkt_lu_factor_blocks", &kkt_lu_factor_blocks_cuda);
  m.impl("kkt_lu_solve", &kkt_lu_solve_cuda);
  m.impl("ell_group", &ell_group_cuda);
  m.impl("ell_cg_start", &ell_cg_start_cuda);
  m.impl("ell_scale", &ell_scale_cuda);
  m.impl("cg_loop", &cg_loop_cuda);
  m.impl("cg_dense_loop", &cg_dense_loop_cuda);
  m.impl("cg_step", &cg_step_cuda);
  m.impl("bt_factor", &bt_factor_cuda);
  m.impl("bt_solve", &bt_solve_cuda);
}

TORCH_LIBRARY_IMPL(osqp_tpu_torch, Meta, m) {
  m.impl("ruiz", &ruiz_meta);
  m.impl("chol_inverse", &square_meta);
  m.impl("chol_inverse_leaf", &square_meta);
  m.impl("chol_inverse_leaf_cluster", &square_cluster_meta);
  m.impl("admm_iter", &admm_iter_meta);
  m.impl("admm_iter_refined", &admm_iter_refined_meta);
  m.impl("admm_iter_refined_resident", &admm_iter_refined_resident_meta);
  m.impl("term_products", &term_products_meta);
  m.impl("kkt_lu_factor_blocks", &kkt_lu_factor_blocks_meta);
  m.impl("kkt_lu_solve", &kkt_lu_solve_meta);
  m.impl("ell_group", &ell_group_meta);
  m.impl("ell_cg_start", &ell_cg_start_meta);
  m.impl("ell_scale", &ell_scale_meta);
  m.impl("cg_loop", &cg_loop_meta);
  m.impl("cg_dense_loop", &cg_dense_loop_meta);
  m.impl("cg_step", &cg_step_meta);
  m.impl("bt_factor", &bt_factor_meta);
  m.impl("bt_solve", &bt_solve_meta);
}
