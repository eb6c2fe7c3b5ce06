"""The port's dry-run (`repro_torch.launch.dryrun`) on meta tensors, and
the report it feeds (`repro_torch.analysis.report`): one cell in process
through the CLI, against JAX's model-FLOP accounting, with no process
group set up."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro import config as jconfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.analysis import report  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    return tmp_path


def test_whisper_train_cell(artifacts):
    """whisper-tiny x train_4k on the 16 x 16 mesh: OK, 6 x JAX's active
    parameters x 256 x 4096 tokens of model FLOPs, every field the report
    reads, the Trainer's collectives, and no process group afterwards."""
    assert dryrun.main(["--arch", "whisper-tiny", "--shape",
                        "train_4k"]) == 0
    path = os.path.join(artifacts, "whisper_tiny_train_4k_16x16.json")
    with open(path) as f:
        d = json.load(f)
    assert d["status"] == "OK" and d["chips"] == 256
    active = jax_build_model(
        jconfig.get_arch("whisper_tiny")).active_param_count()
    assert d["active_params"] == active
    assert d["roofline"]["model_flops"] == 6 * active * 1_048_576
    t = d["roofline"]["terms"]
    for key in ("dominant", "compute_s", "memory_s", "collective_s",
                "roofline_fraction", "mfu_upper_bound",
                "useful_flops_ratio"):
        assert key in t
    assert 0 < t["roofline_fraction"] <= 1
    assert d["roofline"]["argument_bytes"] > 0
    assert d["roofline"]["temp_bytes"] == d["count"]["peak_bytes"] > 0
    # 256 rows over 16 data shards; bf16 products only (the policy's remat
    # recomputes every block: more than 6 N D is counted)
    assert d["rows_per_device"] == 16
    c = d["count"]
    assert c["flops_bf16"] > 0 and c["flops_fp32"] == 0
    held = d["held_bytes"]
    # the tensor-parallel route: a device holds its blocks (whisper's 6
    # heads stay whole on 16 model ranks, its ff columns and FSDP's embed
    # dims split), and the count holds the collectives the step entered:
    # FSDP's gathers and reduce-scatters on "data", the MLPs' reduce-outs
    # on "model"
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as tfm
    with torch.device("meta"):
        whole = sum(p.numel() * p.element_size() for p in tfm.LM(
            get_arch("whisper_tiny")).parameters())
    assert "params_full" not in held and held["params"] * 16 < whole
    for kind in ("all-gather", "reduce-scatter", "model all-reduce"):
        assert c["collective_bytes"][kind] > 0, kind
    assert set(c["kernels"]) == {"flash_attention",
                                 "flash_attention_backward"}
    assert "model" in d["model_axis"]
    table = report.render(report.load(str(artifacts)))
    row = [line for line in table.splitlines() if "whisper_tiny" in line]
    assert len(row) == 1 and row[0].split("|")[-2].strip() in ("FITS",
                                                               "OVER")
    assert not torch.distributed.is_available() or \
        not torch.distributed.is_initialized()


def test_full_attention_long_context_skips(artifacts):
    """A full-attention arch at long_500k is SKIP (`supports_shape`), and
    the report draws it as such."""
    d = dryrun.run_cell("smollm_135m", "long_500k", False)
    assert d["status"] == "SKIP(full-attn)"
    assert "SKIP(full-attn)" in report.render(report.load(str(artifacts)))


def test_local_shapes_follow_the_rules():
    """Placements on the MeshConfig alone: FSDP on "embed" over 16 data
    ranks, heads over 16 model ranks; a vocab that 16 does not divide
    stays whole."""
    from repro_torch.config import MeshConfig
    from repro_torch.distributed.sharding import axis_sizes, make_shardings
    mesh = MeshConfig()
    sizes = axis_sizes(mesh)
    specs = {"wq": ("embed", "heads"), "table": ("vocab", "embed")}
    shapes = {"wq": (576, 576), "table": (49155, 576)}
    place = make_shardings(specs, mesh, dryrun.rules_for("train_4k"),
                           shapes=shapes)
    assert dryrun.local_shape(shapes["wq"], place["wq"], sizes) == (36, 36)
    assert dryrun.local_shape(shapes["table"], place["table"],
                              sizes) == (49155, 36)


def test_sharded_step_counts_adafactor_means(monkeypatch):
    """A scaled-down smollm x train_4k on the 16 x 16 mesh, on its blocks:
    with Adafactor each mean that sums over dims split on "data" or
    "model" is one all-reduce over that axis in the count (the records
    beyond AdamW's step are exactly the means' sums), and both axes have
    such means."""
    from repro_torch import config as tconfig
    from repro_torch.train import trainer as ttrainer
    small = tconfig.scaled_down(tconfig.get_arch("smollm_135m"),
                                num_layers=2, d_model=256, num_heads=16,
                                num_kv_heads=16, d_ff=512, vocab_size=1024)
    monkeypatch.setattr(dryrun, "get_arch", lambda name: small)
    base = dryrun.policy_for
    sums = {}
    reduce = ttrainer._CommMeans.reduce

    def counted(self, s, group):
        name = "model all-reduce" if group == "model" else "all-reduce"
        sums[name] = sums.get(name, 0) + 1
        return reduce(self, s, group)

    monkeypatch.setattr(ttrainer._CommMeans, "reduce", counted)
    counts = {}
    for opt in ("adamw", "adafactor"):
        monkeypatch.setattr(dryrun, "policy_for",
                            lambda m, o=opt: dict(base(m), optimizer=o))
        d = dryrun.count_cell("smollm_135m", "train_4k", False)
        assert d["status"] == "OK" and d["policy"]["optimizer"] == opt
        counts[opt] = d["count"]["collective_counts"]
        if opt == "adamw":
            assert sums == {}
    assert set(sums) == {"all-reduce", "model all-reduce"}
    for name, n in sums.items():
        assert n > 0
        assert counts["adafactor"][name] - counts["adamw"][name] == n, name
