"""The port's two command lines on the CPU, ``train_24p --eval`` and
``eval`` on its checkpoint, each in its own process, and the trainer's
evaluation hook: EMA weights in an eval-mode model of its own, the training
model untouched, ``best_ckpt.pth`` kept on improvement."""

import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from eop_tpu_torch.exp import Exp24P
from eop_tpu_torch.tools import eval as eval_cli
from eop_tpu_torch.tools import train_24p as train_cli
from eop_tpu_torch.train.checkpoint import load_checkpoint
from eop_tpu_torch.train.trainer_24p import Trainer24P
from eop_tpu_torch.utils.synth import write_24p_dataset


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the host's cores, and
    PyTorch's default of a thread per core in each worker oversubscribes
    them (tests/test_torch_bbox_step.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
TINY = ["depth", "0.33", "width", "0.25", "num_classes", "3",
        "input_size", "(64, 64)", "test_size", "(64, 64)",
        "data_num_workers", "0"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli24p")
    return write_24p_dataset(str(root), 4, (90, 160), seed=4)


def run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_train_then_eval_command_lines_on_the_cpu(files, tmp_path):
    img_dir, lab_dir = files
    r = run("eop_tpu_torch.tools.train_24p", "-f",
            "load_train/yolox_24p_train.py", "-b", "2", "--data-dir", img_dir,
            "--label-dir", lab_dir, "--max-epoch", "1", "--eval",
            "--device", "cpu", *TINY, "eval_interval", "1", "test_conf",
            "0.001", "output_dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    run_dir = tmp_path / "yolox_24p"
    assert (run_dir / "last_epoch_ckpt.pth").exists()
    log = (run_dir / "train_log.txt").read_text()
    assert "epoch 1 done" in log and "Average Precision" in log
    assert re.search(r"AP50:95=[0-9.]+ AP50=[0-9.]+", log)
    payload = load_checkpoint(str(run_dir / "last_epoch_ckpt.pth"))
    assert payload["metadata"] == {"start_epoch": 1}
    assert payload["state"]["step"] == 2          # 4 images, batch 2

    r = run("eop_tpu_torch.tools.eval", "-f", "load_eval/yolox_24p_eval.py",
            "-c", str(run_dir / "last_epoch_ckpt.pth"), "-b", "3",
            "--data-dir", img_dir, "--label-dir", lab_dir, "--device", "cpu",
            "--conf", "0.001", *TINY)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Average inference time" in r.stdout
    assert re.search(r"^AP50:95 = [0-9.]+  AP50 = [0-9.]+$", r.stdout,
                     re.MULTILINE)


def test_command_lines_need_a_card_or_the_cpu(files, monkeypatch):
    img_dir, lab_dir = files
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = ["--data-dir", img_dir, "--label-dir", lab_dir, *TINY]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["-b", "2", *data])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.main(["-f", "load_eval/yolox_24p_eval.py", *data])
    for main in (train_cli.main, eval_cli.main):
        with pytest.raises(SystemExit, match="--data-dir"):
            main(["-f", "load_eval/yolox_24p_eval.py", "--device", "cpu"])
    # eop_tpu's parallel flags: --fsdp still needs the card (or --device
    # cpu), --multi-host a coordinator or torchrun's environment, and the
    # live profiler is not ported (ROADMAP's item)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--fsdp", "-b", "2", *data])
    with pytest.raises(ValueError, match="--coordinator"):
        train_cli.main(["--multi-host", "-b", "2", "--device", "cpu", *data])
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        train_cli.main(["--profile-port", "9012", "-b", "2", "--device",
                        "cpu", *data])


def test_eval_weights_prefer_the_ema(tmp_path):
    exp = Exp24P()
    exp.depth, exp.width, exp.num_classes = 0.33, 0.25, 3
    sd = exp.get_model("cpu").state_dict()
    ema = {k: v + 1 for k, v in sd.items() if k.endswith("weight")}
    stats = {k: v + 2 for k, v in sd.items() if k.endswith("running_mean")}
    torch.save({"state": {"model": sd, "ema_params": ema,
                          "ema_batch_stats": stats}}, tmp_path / "ckpt.pth")
    torch.save(sd, tmp_path / "plain.pth")
    got = eval_cli.eval_weights(str(tmp_path / "ckpt.pth"))
    assert got.keys() == sd.keys()
    for k, v in got.items():
        want = ema.get(k, stats.get(k, sd[k]))
        assert torch.equal(v, want), k
    plain = eval_cli.eval_weights(str(tmp_path / "plain.pth"))
    assert all(torch.equal(plain[k], sd[k]) for k in sd)


class SpyExp(Exp24P):
    """Records every model it builds and, at each evaluation, the model it
    is asked to run and the state of the training model at that moment."""

    def __init__(self, aps):
        super().__init__()
        self.models, self.seen, self.aps = [], [], list(aps)

    def get_model(self, device=None, seed=0):
        model = super().get_model(device, seed)
        self.models.append(model)
        return model

    def get_evaluator(self, batch_size):
        exp = self

        class Spy:
            def evaluate(self, infer_fn):
                imgs = torch.zeros(1, 64, 64, 3)
                assert infer_fn(imgs).rows.shape[0] == 1
                return exp.aps.pop(0), 0.5, "spy summary"

        return Spy()

    def get_infer_fn(self, model, device=None):
        live = self.models[0]
        self.seen.append({
            "eval": {k: v.clone() for k, v in model.state_dict().items()},
            "eval_training": model.training,
            "live_training": live.training,
            "live_requires_grad": all(p.requires_grad
                                      for p in live.parameters()),
            "same_module": model is live,
        })
        return super().get_infer_fn(model, device)


def trained(files, out, evaluate):
    exp = SpyExp([0.2, 0.1])
    exp.merge(TINY)
    exp.data_dir, exp.label_dir = files
    exp.max_epoch, exp.L1_epoch, exp.eval_interval = 2, 0, 1
    exp.ema, exp.seed, exp.output_dir = True, 3, str(out)
    trainer = Trainer24P(exp, types.SimpleNamespace(
        batch_size=2, device="cpu", eval=evaluate))
    return exp, trainer.train()


def test_eval_hook_uses_the_ema_and_leaves_training_alone(files, tmp_path):
    exp, state = trained(files, tmp_path / "a", evaluate=True)
    _, plain = trained(files, tmp_path / "b", evaluate=False)
    assert len(exp.seen) == 2 and state.step == plain.step == 4
    for seen in exp.seen:
        assert not seen["eval_training"] and not seen["same_module"]
        assert seen["live_training"] and seen["live_requires_grad"]
    # the second evaluation ran after the last step: the EMA of the end
    last = exp.seen[-1]["eval"]
    ema = {**state.ema_params, **state.ema_batch_stats}
    for k, v in last.items():
        want = ema.get(k, state.model.state_dict()[k])
        assert torch.equal(v, want), k
    live = state.model.state_dict()
    assert any(not torch.equal(live[k], ema[k]) for k in state.ema_params)
    # the steps after an evaluation are those of a run without one
    for k, v in plain.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    for k in plain.ema_params:
        assert torch.equal(state.ema_params[k], plain.ema_params[k]), k
    for pa, pb in zip(state.model.parameters(), plain.model.parameters()):
        assert torch.equal(state.optimizer.state[pa]["momentum_buffer"],
                           plain.optimizer.state[pb]["momentum_buffer"])
    # AP50:95 0.2 then 0.1: best_ckpt.pth is the first epoch's
    run_dir = tmp_path / "a" / exp.exp_name
    best = load_checkpoint(str(run_dir / "best_ckpt.pth"))
    assert best["metadata"] == {"start_epoch": 1} and best["state"]["step"] == 2
    assert not (tmp_path / "b" / exp.exp_name / "best_ckpt.pth").exists()
    log = (run_dir / "train_log.txt").read_text()
    assert log.count("spy summary") == 2 and "AP50:95=0.2000" in log
