// PyTorch binding of the ed25519 kernels (the torch.utils.cpp_extension
// route). The only source that includes torch/extension.h; it is compiled
// by the host compiler, and the kernels (ed25519_kernels.cu) keep a plain
// C interface so that nvcc never sees PyTorch's headers. The Python
// wrappers in ops/ed25519_batch.py and ops/dbl_chain.py check shapes and
// types before calling in; the checks here guard the raw pointers.
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
const char* tm_error_string(int err);
}

namespace {

void check(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void launched(int err) {
  TORCH_CHECK(err == 0, "ed25519 kernel launch failed: ",
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

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("neg_pubkey_table", &neg_pubkey_table);
  m.def("verify_table", &verify_table);
  m.def("verify_generic", &verify_generic);
  m.def("dbl_chain", &dbl_chain);
}
