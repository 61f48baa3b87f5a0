/* ATen's thread-local state, carried from one thread to another: the
 * running profiler's callbacks and its state among it.  A thread that
 * enters a state captured on a thread under torch.profiler records its
 * record_function ranges into that profiler, under its own tid.
 *
 * utils/profiler_tls.py builds this file with the host C++ compiler against
 * torch's headers and loads it with ctypes; turbo/api.py's _map wraps each
 * item of a traced map in enter / leave on whatever thread runs it.
 */
#include <ATen/ThreadLocalState.h>

extern "C" {

void* capture() { return new at::ThreadLocalState(); }

void release(void* state) { delete static_cast<at::ThreadLocalState*>(state); }

void* enter(void* state) {
  return new at::ThreadLocalStateGuard(*static_cast<at::ThreadLocalState*>(state));
}

/* Restores the thread's own state; on the thread that entered. */
void leave(void* guard) { delete static_cast<at::ThreadLocalStateGuard*>(guard); }

}
