"""The profiler on the CPU (``utils/profiler.py``, ``tools/profile_train``,
the trainers' ``--profile-port``):

* ``device_op_table`` on a recorded profile of a 64 px, B=2 24p training
  step: rows sorted by time, ``top`` respected, the categories summing to
  the total of the names, annotated ranges left out (they span operators
  counted already); a profile and the directory ``trace`` wrote give
  one table; the kernel names of the card (templates in an anonymous
  namespace) fall into their categories;
* ``python -m eop_tpu_torch.tools.profile_train --device cpu`` with
  ``--no-trace`` and with a trace: ``eop_tpu``'s lines, the two tables,
  ``--packed`` accepted, ``--hlo-cost`` raising;
* ``train_24p --profile-port`` with ``profile_train --attach`` asking while
  the run trains: the answer's tables, one warm-up step before the
  recorded ones, and the run ending with its checkpoint, its listener
  closed; a capture asked during another gets 409, and one still waiting
  when the run ends 503.
"""

import os
import re
import socket
import threading
import time

import pytest
import torch

from _torch_dist_child import free_port

from eop_tpu_torch.tools import profile_train
from eop_tpu_torch.tools import train_24p as train_24p_cli
from eop_tpu_torch.utils import profiler
from eop_tpu_torch.utils.synth import write_24p_dataset

TINY = ["depth", "0.33", "width", "0.125", "num_classes", "3",
        "input_size", "(64,64)", "test_size", "(64,64)",
        "data_num_workers", "0"]
LOCAL = ["--device", "cpu", "--batch", "2", "--size", "64", "--width",
         "0.125", "--steps", "1", "--trace-steps", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A finished profile of one 24p step (after a warm-up step) and the
    directory ``trace`` wrote it to."""
    args = profile_train.make_parser().parse_args(LOCAL)
    step, state, imgs, labels = profile_train.build(args)
    logdir = str(tmp_path_factory.mktemp("trace"))
    with profiler.trace(logdir, warmup=1) as prof:
        for _ in range(2):
            with profiler.annotate("train_step"):
                state, metrics = step(state, imgs, labels)
            float(metrics["total_loss"])
            prof.step()
    return prof, logdir


def test_device_op_table_sorted_top_and_totals(traced):
    prof, logdir = traced
    rows = profiler.op_table(prof, top=10 ** 6)
    assert len(rows) > 20
    ms = [r[1] for r in rows]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0
    assert all(n > 0 for _, _, n in rows)
    top = profiler.device_op_table(prof, top=5)
    assert top == [(name, t) for name, t, _ in rows[:5]]
    cats = profiler.device_op_table(prof, top=100, by_category=True)
    assert {c for c, _ in cats} <= set(profiler.CATEGORY_NAMES)
    assert sum(t for _, t in cats) == pytest.approx(sum(ms), rel=1e-9)
    # operators only: the annotated ranges span them
    names = [n for n, _, _ in rows]
    assert "train_step" not in names
    assert not any(n.startswith("ProfilerStep") for n in names)
    assert dict(cats)["cuDNN convolution"] > 0
    # the directory holds the same table, and the Chrome trace
    assert profiler.op_table(logdir, top=10 ** 6) == rows
    assert os.path.getsize(os.path.join(logdir, profiler.TRACE_FILE)) > 0
    with pytest.raises(FileNotFoundError, match="ops.json"):
        profiler.device_op_table(os.path.dirname(logdir) + "/none")


@pytest.mark.parametrize("key,name,cat", [
    ("void (anonymous namespace)::conv_taps_kernel<float, 3, true>(float "
     "const*, CUtensorMap_st)", "conv_taps_kernel", "hand kernels"),
    ("void (anonymous namespace)::wgrad_tc_reduce_kernel<16>(float*)",
     "wgrad_tc_reduce_kernel", "hand kernels"),
    ("void (anonymous namespace)::pack_taps_kernel(float const*, int)",
     "pack_taps_kernel", "hand kernels"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "cuDNN convolution"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_16x6_nn>"
     "(Params)", "cutlass::Kernel2", "GEMM"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)",
     "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD", "copy and set"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>(int, float*)",
     "at::native::vectorized_elementwise_kernel", "elementwise"),
    ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)",
     "at::native::reduce_kernel", "reduction"),
    ("aten::sort", "aten::sort", "reduction"),
    ("Optimizer.step#SGD.step", "Optimizer.step#SGD.step", "other"),
])
def test_kernel_names_and_categories(key, name, cat):
    assert profiler.kernel_name(key) == name
    assert profiler.category(name) == cat


def test_profile_train_local(capsys, tmp_path):
    out = profile_train.main([*LOCAL, "--no-trace", "--packed", "false"])
    printed = capsys.readouterr().out
    assert re.search(r"^compile\+first step: [0-9.]+s$", printed, re.M)
    assert re.search(r"^train step: [0-9.]+ ms  \([0-9.]+ img/s\)  B=2 "
                     r"@64px  \(best of 3 passes\)$", printed, re.M)
    assert "device time" not in printed and out["step_ms"] > 0
    out = profile_train.main([*LOCAL, "--top", "6", "--logdir",
                              str(tmp_path)])
    printed = capsys.readouterr().out
    assert f"trace in {tmp_path}" in printed
    for title in ("by category", "top ops"):
        head = f"--- device time {title} (sum over 2 steps) ---"
        assert head in printed
        block = [ln for ln in printed.split(head)[1].split("---")[0]
                 .splitlines() if " ms  " in ln]
        rows = out["tables"][title]
        assert len(block) == len(rows) and 0 < len(rows) <= 6
        assert block[0].split("ms  ", 1)[1] == rows[0][0]
    # on the CPU no kernel launches
    assert out["launches"] == {"forward": 0, "wgrad": 0, "dgrad": 0,
                               "pack": 0}
    with pytest.raises(NotImplementedError, match="Not ported, on purpose"):
        profile_train.main([*LOCAL, "--hlo-cost"])


def test_profile_port_attach_while_training(tmp_path, capsys):
    """The attach is asked before the first step: the trainer arms the
    profiler at the next step boundary, runs one warm-up step, records
    until the window has passed (at least one step) and answers; the run
    goes on to its end and writes its checkpoint."""
    img_dir, lab_dir = write_24p_dataset(str(tmp_path / "d"), 8, (64, 64),
                                         seed=4)
    port = free_port()
    done = {}

    def run():
        try:
            train_24p_cli.main(
                ["-b", "2", "--data-dir", img_dir, "--label-dir", lab_dir,
                 "--device", "cpu", "--profile-port", str(port),
                 "--max-epoch", "2", *TINY, "output_dir",
                 str(tmp_path / "out")])
            done["ok"] = True
        except BaseException as e:  # noqa: BLE001 (reported below)
            done["error"] = e

    trainer = threading.Thread(target=run)
    trainer.start()
    try:
        deadline = time.time() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                assert time.time() < deadline and trainer.is_alive(), done
                time.sleep(0.05)
        answer = profile_train.main(["--attach", f"127.0.0.1:{port}",
                                     "--duration-ms", "1", "--top", "5",
                                     "--logdir", str(tmp_path / "live")])
    finally:
        trainer.join(timeout=300)
    assert done == {"ok": True}, done
    printed = capsys.readouterr().out
    assert answer["steps"] >= 1 and answer["logdir"] == str(tmp_path /
                                                             "live")
    # the trainer's launch counters over the recorded steps (none on the
    # CPU)
    assert answer["launches"] == {"forward": 0, "wgrad": 0, "dgrad": 0,
                                  "pack": 0}
    assert "launches over the recorded steps: forward 0" in printed
    assert "--- device time by category ---" in printed
    assert "--- device time top ops ---" in printed
    top = dict((n, c) for n, _, c in answer["tables"]["top ops"])
    assert len(top) == 5
    assert os.path.exists(tmp_path / "live" / profiler.TRACE_FILE)
    ckpts = [f for _, _, fs in os.walk(tmp_path / "out") for f in fs
             if f.endswith("_ckpt.pth")]
    assert ckpts
    with pytest.raises(OSError):  # the listener closed with the run
        profiler.attach(f"127.0.0.1:{port}", 1, timeout=5)


def test_profile_server_refuses_a_second_capture_and_after_close(
        tmp_path):
    server = profiler.ProfileServer(0, str(tmp_path))
    address = f"127.0.0.1:{server.port}"
    answers = {}

    def ask(key):
        try:
            answers[key] = profiler.attach(address, 1, timeout=30)
        except RuntimeError as e:
            answers[key] = str(e)

    first = threading.Thread(target=ask, args=("first",))
    first.start()
    while server._pending is None:
        time.sleep(0.01)
    ask("second")
    assert answers["second"].endswith("another capture is in progress")
    x = torch.randn(64, 64)
    for _ in range(1000):  # arm, warm up, record until the window ends
        x = x @ x.T / 64
        server.step()
        if "first" in answers:
            break
        time.sleep(0.002)
    first.join(timeout=30)
    assert answers["first"]["steps"] >= 1
    assert answers["first"]["tables"]["top ops"]
    late = threading.Thread(target=ask, args=("late",))
    late.start()
    while server._pending is None:
        time.sleep(0.01)
    server.close()
    late.join(timeout=30)
    assert answers["late"].endswith("before a step was recorded")
