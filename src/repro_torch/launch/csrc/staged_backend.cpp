// The "staged" c10d backend: each collective on the card's tensors runs
// through host buffers on a gloo backend and has finished when the call
// returns.
//
// A c10d backend has to be a C++ ``c10d::Backend``: the functional
// collectives DTensor issues reach a group's backend from C++
// (``ProcessGroup::getBackend``), never its Python methods, and the
// C++ class has no Python constructor to subclass. So this file holds
// the backend and its one Python binding, built by
// ``repro_torch/launch/mesh.py`` at first use.
//
// Every collective copies its inputs to host buffers (pinned for CUDA
// tensors), runs gloo's own op on them, waits for it, and copies the
// results back into the caller's tensors on the caller's current
// stream, synchronously. The work it returns is complete, and every
// result is gloo's own. Each copy's bytes are counted (``staged_bytes``), and each collective's seconds
// on the host's clock, copies included (``staged_seconds``). An op not
// implemented here raises ``Backend staged does not support <op>`` from
// the base class.
#include <torch/csrc/distributed/c10d/Backend.hpp>
#include <torch/csrc/distributed/c10d/Work.hpp>
#include <torch/csrc/utils/pybind.h>

#include <atomic>
#include <chrono>

namespace {

using c10d::Backend;
using c10d::Work;

// A work whose collective has already run.
class DoneWork : public Work {
 public:
  DoneWork(std::vector<at::Tensor> result, c10d::OpType op)
      : Work(-1, op), result_(std::move(result)) {
    future_ = c10::make_intrusive<c10::ivalue::Future>(
        c10::ListType::create(c10::TensorType::get()));
    future_->markCompleted(c10::IValue(result_));
  }
  bool isCompleted() override { return true; }
  bool isSuccess() const override { return true; }
  bool wait(std::chrono::milliseconds) override { return true; }
  void synchronize() override {}
  std::vector<at::Tensor> result() override { return result_; }
  c10::intrusive_ptr<c10::ivalue::Future> getFuture() override {
    return future_;
  }

 private:
  std::vector<at::Tensor> result_;
  c10::intrusive_ptr<c10::ivalue::Future> future_;
};

class StagedBackend : public Backend {
 public:
  StagedBackend(c10::intrusive_ptr<Backend> host, int rank, int size)
      : Backend(rank, size), host_(std::move(host)) {}

  const std::string getBackendName() const override { return "staged"; }

  int64_t stagedBytes() const { return staged_.load(); }

  double stagedSeconds() const { return 1e-9 * nanos_.load(); }

  c10::intrusive_ptr<Work> broadcast(
      std::vector<at::Tensor>& tensors,
      const c10d::BroadcastOptions& opts) override {
    Timer timer(this);
    auto hosts = toHost(tensors);
    host_->broadcast(hosts, opts)->wait();
    backAll(tensors, hosts);
    return done(tensors, c10d::OpType::BROADCAST);
  }

  c10::intrusive_ptr<Work> allreduce(
      std::vector<at::Tensor>& tensors,
      const c10d::AllreduceOptions& opts) override {
    Timer timer(this);
    auto hosts = toHost(tensors);
    host_->allreduce(hosts, opts)->wait();
    backAll(tensors, hosts);
    return done(tensors, c10d::OpType::ALLREDUCE);
  }

  c10::intrusive_ptr<Work> allreduce_coalesced(
      std::vector<at::Tensor>& tensors,
      const c10d::AllreduceCoalescedOptions& opts) override {
    Timer timer(this);
    for (auto& t : tensors) {
      std::vector<at::Tensor> one{t};
      allreduce(one, opts);
    }
    return done(tensors, c10d::OpType::COALESCED);
  }

  c10::intrusive_ptr<Work> _allgather_base(
      at::Tensor& out, at::Tensor& in,
      const c10d::AllgatherOptions& opts) override {
    Timer timer(this);
    auto hin = toHost(in);
    auto hout = hostBuffer(out);
    host_->_allgather_base(hout, hin, opts)->wait();
    back(out, hout);
    return done({out}, c10d::OpType::_ALLGATHER_BASE);
  }

  // the coalesced forms (torch's functional collectives issue these):
  // one host op a pair, in order
  c10::intrusive_ptr<Work> allgather_into_tensor_coalesced(
      std::vector<at::Tensor>& outs, std::vector<at::Tensor>& ins,
      const c10d::AllgatherOptions& opts) override {
    Timer timer(this);
    for (size_t i = 0; i < outs.size(); ++i)
      _allgather_base(outs[i], ins[i], opts);
    return done(outs, c10d::OpType::COALESCED);
  }

  c10::intrusive_ptr<Work> _reduce_scatter_base(
      at::Tensor& out, at::Tensor& in,
      const c10d::ReduceScatterOptions& opts) override {
    Timer timer(this);
    auto hin = toHost(in);
    auto hout = hostBuffer(out);
    host_->_reduce_scatter_base(hout, hin, opts)->wait();
    back(out, hout);
    return done({out}, c10d::OpType::_REDUCE_SCATTER_BASE);
  }

  c10::intrusive_ptr<Work> reduce_scatter_tensor_coalesced(
      std::vector<at::Tensor>& outs, std::vector<at::Tensor>& ins,
      const c10d::ReduceScatterOptions& opts) override {
    Timer timer(this);
    for (size_t i = 0; i < outs.size(); ++i)
      _reduce_scatter_base(outs[i], ins[i], opts);
    return done(outs, c10d::OpType::COALESCED);
  }

  c10::intrusive_ptr<Work> alltoall_base(
      at::Tensor& out, at::Tensor& in, std::vector<int64_t>& outSplit,
      std::vector<int64_t>& inSplit,
      const c10d::AllToAllOptions& opts) override {
    Timer timer(this);
    auto hin = toHost(in);
    auto hout = hostBuffer(out);
    host_->alltoall_base(hout, hin, outSplit, inSplit, opts)->wait();
    back(out, hout);
    return done({out}, c10d::OpType::ALLTOALL_BASE);
  }

  c10::intrusive_ptr<Work> barrier(
      const c10d::BarrierOptions& opts) override {
    Timer timer(this);
    host_->barrier(opts)->wait();
    return done({}, c10d::OpType::BARRIER);
  }

 private:
  static at::Tensor hostBuffer(const at::Tensor& t) {
    return at::empty(t.sizes(), t.options()
                                    .device(at::kCPU)
                                    .pinned_memory(t.is_cuda()));
  }

  at::Tensor toHost(const at::Tensor& t) {
    auto h = hostBuffer(t);
    h.copy_(t);
    staged_ += t.numel() * t.element_size();
    return h;
  }

  std::vector<at::Tensor> toHost(const std::vector<at::Tensor>& ts) {
    std::vector<at::Tensor> hs;
    hs.reserve(ts.size());
    for (const auto& t : ts) hs.push_back(toHost(t));
    return hs;
  }

  void back(at::Tensor& t, const at::Tensor& h) {
    t.copy_(h);
    staged_ += h.numel() * h.element_size();
  }

  void backAll(std::vector<at::Tensor>& ts,
               const std::vector<at::Tensor>& hs) {
    for (size_t i = 0; i < ts.size(); ++i) back(ts[i], hs[i]);
  }

  static c10::intrusive_ptr<Work> done(std::vector<at::Tensor> result,
                                       c10d::OpType op) {
    return c10::make_intrusive<DoneWork>(std::move(result), op);
  }

  // adds its lifetime to nanos_ (the outermost one only: a coalesced
  // call times its whole loop once)
  class Timer {
   public:
    explicit Timer(StagedBackend* b)
        : b_(b), outer_(b->depth_++ == 0),
          t0_(std::chrono::steady_clock::now()) {}
    ~Timer() {
      --b_->depth_;
      if (outer_)
        b_->nanos_ += std::chrono::duration_cast<std::chrono::nanoseconds>(
                          std::chrono::steady_clock::now() - t0_)
                          .count();
    }

   private:
    StagedBackend* b_;
    bool outer_;
    std::chrono::steady_clock::time_point t0_;
  };

  c10::intrusive_ptr<Backend> host_;
  std::atomic<int64_t> staged_{0};
  std::atomic<int64_t> nanos_{0};
  int depth_ = 0;
};

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  py::class_<StagedBackend, Backend, c10::intrusive_ptr<StagedBackend>>(
      m, "StagedBackend")
      .def(py::init<c10::intrusive_ptr<Backend>, int, int>(),
           py::arg("host"), py::arg("rank"), py::arg("size"))
      .def("staged_bytes", &StagedBackend::stagedBytes)
      .def("staged_seconds", &StagedBackend::stagedSeconds);
}
