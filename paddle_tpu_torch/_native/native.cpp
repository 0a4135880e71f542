// The port's native runtime: the host tracer of the JAX package's
// native.cpp (the flags registry, the op registry, the memory counters,
// the executable cache and the TCP store are not here: the port keeps
// its flags, ops and CPU memory counters in Python, reads the card's
// from torch's allocator, and the store waits for the distributed
// package).
//
//  - host tracer    RecordEvent spans collected into a buffer, dumped as
//                   chrome-trace JSON (complete events, "ph": "X")
//
// Exposed through the CPython C API as the module _paddle_torch_native;
// paddle_tpu_torch/_native/__init__.py builds it with g++ at first use.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <chrono>
#include <cstdio>
#include <functional>
#include <iomanip>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// -- host tracer --------------------------------------------------------------
struct TraceEvent {
  std::string name;
  uint64_t tid;
  double t0_us;
  double t1_us;
};

class HostTracer {
 public:
  static HostTracer& Instance() {
    static HostTracer t;
    return t;
  }

  void Start() {
    std::lock_guard<std::mutex> g(mu_);
    enabled_ = true;
    events_.clear();
  }

  void Stop() {
    std::lock_guard<std::mutex> g(mu_);
    enabled_ = false;
  }

  bool enabled() const { return enabled_; }

  double NowUs() const {
    return std::chrono::duration<double, std::micro>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }

  void Record(const std::string& name, double t0, double t1) {
    if (!enabled_) return;
    std::lock_guard<std::mutex> g(mu_);
    events_.push_back(TraceEvent{
        name,
        std::hash<std::thread::id>{}(std::this_thread::get_id()) & 0xffff,
        t0, t1});
  }

  static void EscapeJson(const std::string& s, std::ostringstream& os) {
    for (char c : s) {
      switch (c) {
        case '"': os << "\\\""; break;
        case '\\': os << "\\\\"; break;
        case '\n': os << "\\n"; break;
        case '\r': os << "\\r"; break;
        case '\t': os << "\\t"; break;
        default:
          if (static_cast<unsigned char>(c) < 0x20) {
            char buf[8];
            std::snprintf(buf, sizeof(buf), "\\u%04x", c);
            os << buf;
          } else {
            os << c;
          }
      }
    }
  }

  // Chrome trace format (ref: chrometracing_logger.cc)
  std::string DumpJson() const {
    std::lock_guard<std::mutex> g(mu_);
    std::ostringstream os;
    // microseconds since boot need more than the stream's default six
    // significant digits: fixed, to the nanosecond
    os << std::fixed << std::setprecision(3);
    os << "{\"traceEvents\":[";
    for (size_t i = 0; i < events_.size(); ++i) {
      const auto& e = events_[i];
      if (i) os << ",";
      os << "{\"name\":\"";
      EscapeJson(e.name, os);
      os << "\",\"ph\":\"X\",\"pid\":0,"
         << "\"tid\":" << e.tid << ",\"ts\":" << e.t0_us
         << ",\"dur\":" << (e.t1_us - e.t0_us) << "}";
    }
    os << "]}";
    return os.str();
  }

  size_t Size() const {
    std::lock_guard<std::mutex> g(mu_);
    return events_.size();
  }

 private:
  mutable std::mutex mu_;
  std::atomic<bool> enabled_{false};
  std::vector<TraceEvent> events_;
};

}  // namespace

extern "C" {

static PyObject* py_tracer_start(PyObject*, PyObject*) {
  HostTracer::Instance().Start();
  Py_RETURN_NONE;
}

static PyObject* py_tracer_stop(PyObject*, PyObject*) {
  HostTracer::Instance().Stop();
  Py_RETURN_NONE;
}

static PyObject* py_tracer_now(PyObject*, PyObject*) {
  return PyFloat_FromDouble(HostTracer::Instance().NowUs());
}

static PyObject* py_tracer_record(PyObject*, PyObject* args) {
  const char* name;
  double t0, t1;
  if (!PyArg_ParseTuple(args, "sdd", &name, &t0, &t1)) return nullptr;
  HostTracer::Instance().Record(name, t0, t1);
  Py_RETURN_NONE;
}

static PyObject* py_tracer_enabled(PyObject*, PyObject*) {
  if (HostTracer::Instance().enabled()) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

static PyObject* py_tracer_dump(PyObject*, PyObject*) {
  std::string s = HostTracer::Instance().DumpJson();
  return PyUnicode_FromStringAndSize(s.data(), s.size());
}

static PyObject* py_tracer_size(PyObject*, PyObject*) {
  return PyLong_FromSize_t(HostTracer::Instance().Size());
}

static PyMethodDef Methods[] = {
    {"tracer_start", py_tracer_start, METH_NOARGS,
     "start host tracer"},
    {"tracer_stop", py_tracer_stop, METH_NOARGS,
     "stop host tracer"},
    {"tracer_now", py_tracer_now, METH_NOARGS,
     "monotonic us"},
    {"tracer_record", py_tracer_record, METH_VARARGS,
     "record span"},
    {"tracer_enabled", py_tracer_enabled, METH_NOARGS,
     "tracer on?"},
    {"tracer_dump", py_tracer_dump, METH_NOARGS,
     "chrome trace json"},
    {"tracer_size", py_tracer_size, METH_NOARGS,
     "event count"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                                       "_paddle_torch_native",
                                       "paddle_tpu_torch native runtime",
                                       -1,
                                       Methods};

PyMODINIT_FUNC PyInit__paddle_torch_native(void) {
  return PyModule_Create(&moduledef);
}

}  // extern "C"
