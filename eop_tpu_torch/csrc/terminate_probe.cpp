// Native terminate / SIGABRT probe for a process that aborts in code with no
// Python state ("terminate called without an active exception").  Python's
// faulthandler cannot name such a thread; this handler runs on the aborting
// thread itself.  terminate_probe_install(path) sets std::set_terminate and
// a SIGABRT sigaction; either writes to `path`:
//   * the aborting thread's id and name and what aborted it;
//   * backtrace() + backtrace_symbols_fd of that thread;
//   * dladdr of each frame: the shared object, the nearest symbol, offsets;
//   * the id and name of every thread of the process (/proc/self/task/*/comm);
// then restores the SIGABRT action found at install (e.g. faulthandler's,
// which dumps the Python threads next) and aborts again: std::terminate
// calls abort(); the SIGABRT handler raises SIGABRT, held until it returns
// and then delivered to that action.
//
// Host library, flat extern "C" ABI bound with ctypes, built by
// eop_tpu_torch/_build.py only when asked for (chip_smoke.py
// --probe-worker-exit loads it in its loader workers).  The handlers use
// only write(2), open(2), read(2), getdents64(2) and the unwinder: no stdio,
// no malloc after install.

#include <dlfcn.h>
#include <execinfo.h>
#include <fcntl.h>
#include <signal.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>

namespace {

int g_fd = -1;
struct sigaction g_prev_abrt;
std::atomic<int> g_dumped{0};

void put(const char* s) {
  size_t n = std::strlen(s);
  while (n > 0) {
    ssize_t w = ::write(g_fd, s, n);
    if (w <= 0) return;
    s += w;
    n -= static_cast<size_t>(w);
  }
}

void put_uint(uint64_t v, int base = 10) {
  char buf[32];
  int i = 31;
  buf[i] = '\0';
  do {
    int d = static_cast<int>(v % base);
    buf[--i] = static_cast<char>(d < 10 ? '0' + d : 'a' + d - 10);
    v /= base;
  } while (v && i > 2);
  if (base == 16) {
    buf[--i] = 'x';
    buf[--i] = '0';
  }
  put(buf + i);
}

// the first line of a small /proc file, without its newline
void put_file_line(const char* path) {
  int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) {
    put("?");
    return;
  }
  char buf[64];
  ssize_t n = ::read(fd, buf, sizeof(buf) - 1);
  ::close(fd);
  if (n <= 0) {
    put("?");
    return;
  }
  buf[n] = '\0';
  for (ssize_t i = 0; i < n; ++i)
    if (buf[i] == '\n') buf[i] = '\0';
  put(buf);
}

struct LinuxDirent64 {
  uint64_t d_ino;
  int64_t d_off;
  unsigned short d_reclen;
  unsigned char d_type;
  char d_name[1];
};

void put_threads() {
  int dir = ::open("/proc/self/task", O_RDONLY | O_DIRECTORY | O_CLOEXEC);
  if (dir < 0) {
    put("  (no /proc/self/task)\n");
    return;
  }
  alignas(8) char buf[4096];
  for (;;) {
    long n = ::syscall(SYS_getdents64, dir, buf, sizeof(buf));
    if (n <= 0) break;
    for (long off = 0; off < n;) {
      auto* e = reinterpret_cast<LinuxDirent64*>(buf + off);
      off += e->d_reclen;
      if (e->d_name[0] == '.') continue;
      char path[96] = "/proc/self/task/";
      std::strncat(path, e->d_name, 32);
      std::strncat(path, "/comm", 8);
      put("  ");
      put(e->d_name);
      put(" ");
      put_file_line(path);
      put("\n");
    }
  }
  ::close(dir);
}

void dump(const char* why) {
  if (g_fd < 0 || g_dumped.exchange(1)) return;
  put("== ");
  put(why);
  put(" on thread ");
  put_uint(static_cast<uint64_t>(::syscall(SYS_gettid)));
  put(" ");
  put_file_line("/proc/thread-self/comm");
  put(" of pid ");
  put_uint(static_cast<uint64_t>(::getpid()));
  put("\n-- backtrace\n");
  void* frames[64];
  int n = ::backtrace(frames, 64);
  ::backtrace_symbols_fd(frames, n, g_fd);
  put("-- objects (frame address, shared object, symbol + offset)\n");
  for (int i = 0; i < n; ++i) {
    Dl_info info;
    put("  #");
    put_uint(static_cast<uint64_t>(i));
    put(" ");
    put_uint(reinterpret_cast<uintptr_t>(frames[i]), 16);
    if (::dladdr(frames[i], &info) && info.dli_fname) {
      put(" ");
      put(info.dli_fname);
      put(" +");
      put_uint(reinterpret_cast<uintptr_t>(frames[i]) -
                   reinterpret_cast<uintptr_t>(info.dli_fbase),
               16);
      if (info.dli_sname) {
        put(" ");
        put(info.dli_sname);
        put(" +");
        put_uint(reinterpret_cast<uintptr_t>(frames[i]) -
                     reinterpret_cast<uintptr_t>(info.dli_saddr),
                 16);
      }
    } else {
      put(" ?");
    }
    put("\n");
  }
  put("-- threads (tid comm)\n");
  put_threads();
  put("== end\n");
}

void on_terminate() {
  dump(std::current_exception() ? "std::terminate with an active exception"
                                : "std::terminate without an active exception");
  ::sigaction(SIGABRT, &g_prev_abrt, nullptr);
  std::abort();
}

void on_abort(int, siginfo_t*, void*) {
  dump("SIGABRT");
  ::sigaction(SIGABRT, &g_prev_abrt, nullptr);
  ::raise(SIGABRT);  // blocked in this handler: delivered when it returns
}

}  // namespace

extern "C" {

// Install both handlers, dumping to `path` (appended); 0 or an errno.
int terminate_probe_install(const char* path) {
  g_fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND | O_CLOEXEC, 0644);
  if (g_fd < 0) return errno;
  // the first backtrace() loads the unwinder (and may allocate): do it here,
  // not in the handler
  void* warm[4];
  ::backtrace(warm, 4);
  struct sigaction sa;
  std::memset(&sa, 0, sizeof(sa));
  sa.sa_sigaction = on_abort;
  sa.sa_flags = SA_SIGINFO;
  sigemptyset(&sa.sa_mask);
  if (::sigaction(SIGABRT, &sa, &g_prev_abrt) != 0) return errno;
  std::set_terminate(on_terminate);
  return 0;
}

}  // extern "C"
