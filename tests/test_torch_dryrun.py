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


def test_placed_trainer_updates_this_devices_blocks():
    """`PlacedTrainer` on the 16 x 16 mesh's placements: one AdamW step on
    the CPU gives the Trainer's loss and, in every parameter block, bitwise
    the block of the Trainer's full update (AdamW is elementwise); with
    Adafactor on meta its means over split dims are counted as
    all-reduces."""
    from repro_torch.analysis.counting import StepCount
    from repro_torch.config import MeshConfig, TrainConfig, get_arch, \
        scaled_down
    from repro_torch.distributed.sharding import axis_sizes, make_shardings
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model_zoo import build_model
    cfg = scaled_down(get_arch("smollm_135m"), num_layers=2, d_model=64,
                      vocab_size=300)
    model = build_model(cfg)
    mesh = MeshConfig()
    sizes = axis_sizes(mesh)
    policy = dict(optimizer="adamw", remat="none", microbatch=1)
    tokens = torch.randint(0, 300, (2, 16),
                           generator=torch.Generator().manual_seed(1))

    def placed(params):
        named = {n.replace(".", "/"): p for n, p in params.named_parameters()}
        specs = model.param_specs()
        return make_shardings({k: specs[k] for k in named}, mesh,
                              dryrun.rules_for("train_4k", cfg),
                              shapes=named)

    full = dryrun.make_train_step(model, model.init(0, device="cpu"),
                                  policy, TrainConfig())
    params = model.init(0, device="cpu")
    place = placed(params)
    part = dryrun.make_train_step(model, params, policy, TrainConfig(),
                                  place, sizes)
    a = full.advance({"tokens": tokens})
    b = part.advance({"tokens": tokens})
    assert torch.equal(a["loss"], b["loss"])
    for k, block in part.blocks.items():
        want = dryrun._local(full.state.params[k], place[k], sizes)
        assert torch.equal(block, want), k

    with torch.device("meta"):
        meta_params = tfm.LM(cfg)
    policy = dict(policy, optimizer="adafactor")
    meta = dryrun.make_train_step(model, meta_params, policy, TrainConfig(),
                                  placed(meta_params), sizes)
    with StepCount() as count:
        meta.advance({"tokens": torch.empty((2, 16), dtype=torch.int64,
                                            device="meta")})
    assert count.collective_bytes.get("all-reduce", 0) > 0
    assert all(v.device.type == "meta" for v in meta.blocks.values())
