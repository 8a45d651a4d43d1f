"""Stage attribution and idle time on a hand-made profiler trace."""

import json

import pytest

from perfbench.trace import analyse


def X(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_stages_follow_the_synchronizes(tmp_path):
    ev = [X("user_annotation", "perfbench.inference", 0, 100)]
    launches = [(5, "a"), (20, "b"), (40, "c"), (60, "d"), (70, "e")]
    for i, (ts, name) in enumerate(launches):
        ev.append(X("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=i))
        ev.append(X("kernel", name, ts + 2, 4, tid=7, corr=i))
    ev.append(X("cuda_runtime", "cudaDeviceSynchronize", 10, 5))   # ends stage one after "a"
    ev.append(X("cuda_runtime", "cudaDeviceSynchronize", 50, 5))   # ends stage two after "b", "c"
    ev.append(X("cuda_runtime", "cudaMemcpyAsync", 65, 1, corr=9))  # the result copied back ends stage three
    ev.append(X("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 66, 2, tid=7, corr=9))
    ev.append(X("cpu_op", "aten::argmax", 80, 15))
    # another thread's launch inside the call belongs to no stage
    ev.append(X("cuda_runtime", "cudaLaunchKernel", 30, 1, tid=2, corr=20))
    ev.append(X("kernel", "copy", 31, 3, tid=8, corr=20))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = analyse(str(path), ["one", "two", "three"])
    (c,) = s.calls
    assert c.ops == {"one": 1, "two": 2, "three": 2}
    assert c.device_s["two"] == pytest.approx(8e-6) and c.device_s["three"] == pytest.approx(6e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(25e-6)  # five kernels of 4, copies of 3 and 2, the last touching "d"
    assert dict(s.device_ops)["a"] == pytest.approx(4e-6)
    assert any(name.endswith("aten::argmax") for name, _ in s.idle_gaps)


def test_a_call_with_other_synchronizes_is_not_placed(tmp_path):
    ev = [X("user_annotation", "perfbench.inference", 0, 10), X("cuda_runtime", "cudaDeviceSynchronize", 1, 1)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert analyse(str(path), ["one", "two", "three"]).calls == [None]
