// PyTorch binding of the ed25519, SHA-512, BLS12-381, secp256k1 and
// SHA-256 kernels (the torch.utils.cpp_extension route). The only source
// that includes torch/extension.h; it is compiled by the host compiler, and
// the kernels (ed25519_kernels.cu, sha512_kernels.cu, bls_kernels.cu,
// secp256k1_kernels.cu, sha256_kernels.cu) keep a plain C interface so that
// nvcc never sees PyTorch's headers. The Python wrappers in
// ops/ed25519_batch.py, ops/sha512.py, ops/dbl_chain.py, ops/bls_*.py,
// ops/secp256k1_kernel.py and ops/sha256.py check shapes and types before
// calling in, through ops/_build.launch, which makes the operands' device
// current for the launch; the checks here guard the raw pointers.
#include <torch/extension.h>

extern "C" {
int tm_neg_pubkey_table(const void* pub, void* tables, void* valid,
                        const void* kbytes, int n, void* stream);
int tm_verify_table(const void* tables, const void* tvalid, int rows,
                    const void* idx, const void* r, const void* s,
                    const void* k, const void* s_ok, const void* base,
                    const void* kbytes, void* out, int b, void* stream);
int tm_verify_generic(const void* pub, const void* r, const void* s,
                      const void* k, const void* s_ok, const void* base,
                      const void* kbytes, void* out, int b, void* stream);
int tm_dbl_chain(const void* in, void* out, int b, int n_dbl, void* stream);
int tm_neg_pubkey_bigtable(const void* pub, void* tables, void* valid,
                           const void* kbytes, int n, void* stream);
int tm_verify_bigcache(const void* tables, const void* tvalid, int rows,
                       const void* idx, const void* r, const void* s,
                       const void* k, const void* s_ok, const void* base,
                       const void* kbytes, void* out, int b, void* stream);
int tm_challenge(const void* msg, int nblk, const void* n_blocks, void* out,
                 int b, void* stream);
int tm_reduce_mod_l(const void* digest, void* out, int b, void* stream);
int tm_g1_aggregate(const void* in, void* scratch, void* out, int ntrees,
                    int b, int nb, void* stream);
int tm_g2_aggregate(const void* in, void* scratch, void* out, int ntrees,
                    int b, int nb, void* stream);
int tm_g1_add(const void* p, const void* q, void* out, int n, void* stream);
int tm_g2_add(const void* p, const void* q, void* out, int n, void* stream);
int tm_miller(const void* xp, const void* yp, const void* xq, const void* yq,
              const void* valid, void* scratch, void* out, int c,
              void* stream);
int tm_final_exp(const void* in, void* out, int n, void* stream);
int tm_secp_verify(const void* qx, const void* qy, const void* u1,
                   const void* u2, const void* r, const void* ok_in,
                   const void* gtab, void* out, int b, void* stream);
int tm_sha256(const void* msg, int nblk, const void* n_blocks, void* out,
              int b, void* stream);
const char* tm_error_string(int err);
}

namespace {

void check(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void launched(int err) {
  TORCH_CHECK(err == 0, "kernel launch failed: ",
              tm_error_string(err));
}

void* stream_ptr(int64_t stream) { return reinterpret_cast<void*>(stream); }

void neg_pubkey_table(torch::Tensor pub, torch::Tensor tables,
                      torch::Tensor valid, torch::Tensor kbytes,
                      int64_t stream) {
  check(pub, "pubkeys");
  check(tables, "tables");
  check(valid, "valid");
  check(kbytes, "consts");
  launched(tm_neg_pubkey_table(pub.data_ptr(), tables.data_ptr(),
                               valid.data_ptr(), kbytes.data_ptr(),
                               (int)pub.size(0), stream_ptr(stream)));
}

void verify_table(torch::Tensor tables, torch::Tensor tvalid,
                  torch::Tensor idx, torch::Tensor r, torch::Tensor s,
                  torch::Tensor k, torch::Tensor s_ok, torch::Tensor base,
                  torch::Tensor kbytes, torch::Tensor out, int64_t stream) {
  for (auto* t : {&tables, &tvalid, &idx, &r, &s, &k, &s_ok, &base, &kbytes,
                  &out})
    check(*t, "verify_table operand");
  launched(tm_verify_table(tables.data_ptr(), tvalid.data_ptr(),
                           (int)tables.size(0), idx.data_ptr(), r.data_ptr(),
                           s.data_ptr(), k.data_ptr(), s_ok.data_ptr(),
                           base.data_ptr(), kbytes.data_ptr(), out.data_ptr(),
                           (int)out.size(0), stream_ptr(stream)));
}

void verify_generic(torch::Tensor pub, torch::Tensor r, torch::Tensor s,
                    torch::Tensor k, torch::Tensor s_ok, torch::Tensor base,
                    torch::Tensor kbytes, torch::Tensor out, int64_t stream) {
  for (auto* t : {&pub, &r, &s, &k, &s_ok, &base, &kbytes, &out})
    check(*t, "verify_generic operand");
  launched(tm_verify_generic(pub.data_ptr(), r.data_ptr(), s.data_ptr(),
                             k.data_ptr(), s_ok.data_ptr(), base.data_ptr(),
                             kbytes.data_ptr(), out.data_ptr(),
                             (int)out.size(0), stream_ptr(stream)));
}

void dbl_chain(torch::Tensor in, torch::Tensor out, int64_t n_dbl,
               int64_t stream) {
  check(in, "points");
  check(out, "out");
  launched(tm_dbl_chain(in.data_ptr(), out.data_ptr(), (int)in.size(0),
                        (int)n_dbl, stream_ptr(stream)));
}

void neg_pubkey_bigtable(torch::Tensor pub, torch::Tensor tables,
                         torch::Tensor valid, torch::Tensor kbytes,
                         int64_t stream) {
  check(pub, "pubkeys");
  check(tables, "tables");
  check(valid, "valid");
  check(kbytes, "consts");
  launched(tm_neg_pubkey_bigtable(pub.data_ptr(), tables.data_ptr(),
                                  valid.data_ptr(), kbytes.data_ptr(),
                                  (int)pub.size(0), stream_ptr(stream)));
}

void verify_bigcache(torch::Tensor tables, torch::Tensor tvalid,
                     torch::Tensor idx, torch::Tensor r, torch::Tensor s,
                     torch::Tensor k, torch::Tensor s_ok, torch::Tensor base,
                     torch::Tensor kbytes, torch::Tensor out, int64_t stream) {
  for (auto* t : {&tables, &tvalid, &idx, &r, &s, &k, &s_ok, &base, &kbytes,
                  &out})
    check(*t, "verify_bigcache operand");
  launched(tm_verify_bigcache(tables.data_ptr(), tvalid.data_ptr(),
                              (int)tables.size(0), idx.data_ptr(),
                              r.data_ptr(), s.data_ptr(), k.data_ptr(),
                              s_ok.data_ptr(), base.data_ptr(),
                              kbytes.data_ptr(), out.data_ptr(),
                              (int)out.size(0), stream_ptr(stream)));
}

void challenge(torch::Tensor msg, torch::Tensor n_blocks, torch::Tensor out,
               int64_t stream) {
  check(msg, "msg_buf");
  check(n_blocks, "n_blocks");
  check(out, "out");
  launched(tm_challenge(msg.data_ptr(), (int)(msg.size(1) / 128),
                        n_blocks.data_ptr(), out.data_ptr(), (int)out.size(0),
                        stream_ptr(stream)));
}

void reduce_mod_l(torch::Tensor digest, torch::Tensor out, int64_t stream) {
  check(digest, "digest");
  check(out, "out");
  launched(tm_reduce_mod_l(digest.data_ptr(), out.data_ptr(),
                           (int)out.size(0), stream_ptr(stream)));
}

using aggregate_fn = int (*)(const void*, void*, void*, int, int, int, void*);

void aggregate(aggregate_fn fn, torch::Tensor in, torch::Tensor scratch,
               torch::Tensor out, int64_t ntrees, int64_t b, int64_t nb,
               int64_t stream) {
  check(in, "points");
  check(scratch, "scratch");
  check(out, "out");
  launched(fn(in.data_ptr(), scratch.data_ptr(), out.data_ptr(), (int)ntrees,
              (int)b, (int)nb, stream_ptr(stream)));
}

void g1_aggregate(torch::Tensor in, torch::Tensor scratch, torch::Tensor out,
                  int64_t ntrees, int64_t b, int64_t nb, int64_t stream) {
  aggregate(tm_g1_aggregate, in, scratch, out, ntrees, b, nb, stream);
}

void g2_aggregate(torch::Tensor in, torch::Tensor scratch, torch::Tensor out,
                  int64_t ntrees, int64_t b, int64_t nb, int64_t stream) {
  aggregate(tm_g2_aggregate, in, scratch, out, ntrees, b, nb, stream);
}

using add_fn = int (*)(const void*, const void*, void*, int, void*);

void add_points(add_fn fn, torch::Tensor p, torch::Tensor q,
                torch::Tensor out, int64_t stream) {
  check(p, "p");
  check(q, "q");
  check(out, "out");
  launched(fn(p.data_ptr(), q.data_ptr(), out.data_ptr(), (int)out.size(0),
              stream_ptr(stream)));
}

void g1_add(torch::Tensor p, torch::Tensor q, torch::Tensor out,
            int64_t stream) {
  add_points(tm_g1_add, p, q, out, stream);
}

void g2_add(torch::Tensor p, torch::Tensor q, torch::Tensor out,
            int64_t stream) {
  add_points(tm_g2_add, p, q, out, stream);
}

void miller(torch::Tensor xp, torch::Tensor yp, torch::Tensor xq,
            torch::Tensor yq, torch::Tensor valid, torch::Tensor scratch,
            torch::Tensor out, int64_t stream) {
  for (auto* t : {&xp, &yp, &xq, &yq, &valid, &scratch, &out})
    check(*t, "miller operand");
  launched(tm_miller(xp.data_ptr(), yp.data_ptr(), xq.data_ptr(),
                     yq.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
                     out.data_ptr(), (int)xp.size(0), stream_ptr(stream)));
}

void final_exp(torch::Tensor in, torch::Tensor out, int64_t stream) {
  check(in, "f");
  check(out, "out");
  launched(tm_final_exp(in.data_ptr(), out.data_ptr(), (int)in.size(0),
                        stream_ptr(stream)));
}

void secp_verify(torch::Tensor qx, torch::Tensor qy, torch::Tensor u1,
                 torch::Tensor u2, torch::Tensor r, torch::Tensor ok_in,
                 torch::Tensor gtab, torch::Tensor out, int64_t stream) {
  for (auto* t : {&qx, &qy, &u1, &u2, &r, &ok_in, &gtab, &out})
    check(*t, "secp_verify operand");
  launched(tm_secp_verify(qx.data_ptr(), qy.data_ptr(), u1.data_ptr(),
                          u2.data_ptr(), r.data_ptr(), ok_in.data_ptr(),
                          gtab.data_ptr(), out.data_ptr(), (int)out.size(0),
                          stream_ptr(stream)));
}

void sha256(torch::Tensor msg, torch::Tensor n_blocks, torch::Tensor out,
            int64_t stream) {
  check(msg, "msg_buf");
  check(n_blocks, "n_blocks");
  check(out, "out");
  launched(tm_sha256(msg.data_ptr(), (int)(msg.size(1) / 64),
                     n_blocks.data_ptr(), out.data_ptr(), (int)out.size(0),
                     stream_ptr(stream)));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("neg_pubkey_table", &neg_pubkey_table);
  m.def("verify_table", &verify_table);
  m.def("verify_generic", &verify_generic);
  m.def("dbl_chain", &dbl_chain);
  m.def("neg_pubkey_bigtable", &neg_pubkey_bigtable);
  m.def("verify_bigcache", &verify_bigcache);
  m.def("challenge", &challenge);
  m.def("reduce_mod_l", &reduce_mod_l);
  m.def("g1_aggregate", &g1_aggregate);
  m.def("g2_aggregate", &g2_aggregate);
  m.def("g1_add", &g1_add);
  m.def("g2_add", &g2_add);
  m.def("miller", &miller);
  m.def("final_exp", &final_exp);
  m.def("secp_verify", &secp_verify);
  m.def("sha256", &sha256);
}
