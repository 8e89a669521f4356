"""The port's own copies of the JAX package's numpy-only modules against the
JAX modules: `core.config`, `core.schedule`, `core.gamma`, `api`'s tables,
`utils.metadata`, `models.text_encoders.MockTextEncoder` and the CLI's
parser.  The port imports none of `regione_tpu`, so these copies must stay
equal to the originals; every case runs over the five backends of
`DEFAULT_PARAMS`.  Exact equality throughout: the copies are the same
code on the same numbers.  The port adds one backend of its own
(`PORT_ONLY`: FLUX.2 [dev], which the JAX package lacks) to its knobs, its
gamma tables and the CLI's `--backend` choices, and to nothing else."""

import dataclasses

import numpy as np
import pytest

from regione_tpu import api as japi
from regione_tpu.cli import main as jcli
from regione_tpu.core import config as jconfig
from regione_tpu.core import gamma as jgamma
from regione_tpu.core import schedule as jschedule
from regione_tpu.models.text_encoders import MockTextEncoder as JMock
from regione_tpu.utils import metadata as jmeta
from regione_tpu_torch import api as tapi
from regione_tpu_torch.cli import main as tcli
from regione_tpu_torch.core import config as tconfig
from regione_tpu_torch.core import gamma as tgamma
from regione_tpu_torch.core import schedule as tschedule
from regione_tpu_torch.models.text_encoders import MockTextEncoder as TMock
from regione_tpu_torch.utils import metadata as tmeta

BACKENDS = sorted(jconfig.DEFAULT_PARAMS)
PORT_ONLY = ["flux2-dev"]


def test_the_copies_cover_the_same_backends():
    assert sorted(tconfig.DEFAULT_PARAMS) == sorted(BACKENDS + PORT_ONLY)
    assert sorted(tgamma.GAMMA_TABLES) == \
        sorted(list(jgamma.GAMMA_TABLES) + PORT_ONLY)
    assert len(BACKENDS) == 5


@pytest.mark.parametrize("backend", BACKENDS)
def test_params_and_defaults_tables_equal(backend):
    jp, tp = jconfig.DEFAULT_PARAMS[backend], tconfig.DEFAULT_PARAMS[backend]
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.refresh_with_sentinel == jp.refresh_with_sentinel
    assert tapi.BACKEND_DEFAULTS[backend] == japi.BACKEND_DEFAULTS[backend]
    for refresh in ("14", "12,18", (20, 11), 16):
        assert (tp.replace(refresh_step=refresh).refresh_step
                == jp.replace(refresh_step=refresh).refresh_step)
    for bad in (dict(refresh_step="12,13"), dict(num_inference_steps=30),
                dict(refresh_step="7")):
        with pytest.raises(AssertionError):
            jp.replace(**bad).validate()
        with pytest.raises(AssertionError):
            tp.replace(**bad).validate()
    assert (tapi._REFERENCE_CLASS_ALIASES
            == japi._REFERENCE_CLASS_ALIASES)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gamma_and_sigmas_equal(backend):
    jg, tg = jgamma.gamma_for(backend), tgamma.gamma_for(backend)
    assert tg.dtype == jg.dtype and np.array_equal(tg, jg)
    for seq in (256, 1024, 4096):
        mu = jschedule.calculate_shift(seq)
        assert tschedule.calculate_shift(seq) == mu
        np.testing.assert_array_equal(tschedule.build_sigmas(28, mu=mu),
                                      jschedule.build_sigmas(28, mu=mu))
    np.testing.assert_array_equal(
        tschedule.build_sigmas(20, shift=3.0, use_dynamic_shifting=False),
        jschedule.build_sigmas(20, shift=3.0, use_dynamic_shifting=False))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("change", [{}, dict(warmup_step=5, refresh_step="14"),
                                    dict(refresh_step="12,18", post_step=3),
                                    dict(cache_threshold=0.2)])
def test_stage_plan_equal(backend, change):
    sig = jschedule.build_sigmas(28, mu=jschedule.calculate_shift(4096))
    jp = jconfig.DEFAULT_PARAMS[backend].replace(**change)
    tp = tconfig.DEFAULT_PARAMS[backend].replace(**change)
    jplan = jschedule.build_stage_plan(jp, sig, jgamma.gamma_for(backend))
    tplan = tschedule.build_stage_plan(tp, sig, tgamma.gamma_for(backend))
    assert ([dataclasses.asdict(s) for s in tplan]
            == [dataclasses.asdict(s) for s in jplan])
    assert tschedule.describe_plan(tplan) == jschedule.describe_plan(jplan)
    assert ([(k, [s.index for s in run])
             for k, run in tschedule.plan_segments(tplan)]
            == [(k, [s.index for s in run])
                for k, run in jschedule.plan_segments(jplan)])
    for name in ("KV_NORMAL", "KV_CACHE_WRITE", "KV_RAGS", "SCHED_EULER",
                 "SCHED_PARTITION", "SCHED_REFRESH", "AFTER_NONE",
                 "AFTER_SHRINK", "AFTER_MERGE"):
        assert getattr(tschedule, name) == getattr(jschedule, name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_pick_capacity_equal(backend):
    gran = tconfig.DEFAULT_PARAMS[backend].capacity_granularity
    for seq in (64, 1024, 4096):
        for n in (0, 1, 37, 127, 128, 129, 900, 4096, 5000):
            for g in (gran, 16, 256):
                assert (tconfig.pick_capacity(n, seq, g)
                        == jconfig.pick_capacity(n, seq, g))
    assert tconfig.round_up(130, 64) == jconfig.round_up(130, 64)


@pytest.mark.parametrize("backend", BACKENDS)
def test_parser_equal_plus_device(backend):
    """Every dest, default and choice of the JAX parser; `--device`
    defaults to cuda in the port (the JAX CLI ignores its value)."""
    jp, tp = jcli.make_parser(), tcli.make_parser()
    jacts = {a.dest: a for a in jp._actions}
    tacts = {a.dest: a for a in tp._actions}
    assert set(tacts) == set(jacts)
    for dest, ja in jacts.items():
        ta = tacts[dest]
        assert ta.option_strings == ja.option_strings
        if dest == "backend":
            assert ta.choices == ja.choices + PORT_ONLY
        else:
            assert ta.choices == ja.choices
        assert ta.nargs == ja.nargs
        assert ta.const == ja.const
        if dest != "device":
            assert ta.default == ja.default, dest
    assert tp.get_default("device") == "cuda"
    argv = ["--backend", backend, "--erosion_dilation", "False",
            "--int4_mods", "yes", "--quantize_mods", "0", "--refresh_step",
            "14", "--seed", "3", "--ref_image_path", "a.png",
            "--ref_image_path", "b.png", "--save_format", "webp"]
    jv, tv = vars(jp.parse_args(argv)), vars(tp.parse_args(argv))
    assert jv.pop("device") is None and tv.pop("device") == "cuda"
    assert tv == jv
    assert tp.parse_args(["--erosion_dilation"]).erosion_dilation is True


@pytest.mark.parametrize("backend", BACKENDS)
def test_mock_text_encoder_equal(backend):
    dims = {"flux-kontext": (4096, 768)}.get(backend, (64, None))
    img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    for prompt, image in (("make the sky darker", None),
                          (backend, img), ("x", [img, img[::-1]])):
        for max_length in (8, 128):
            want = JMock(*dims, max_length=max_length).encode(prompt, image)
            got = TMock(*dims, max_length=max_length).encode(prompt, image)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("backend", BACKENDS)
def test_metadata_resolution_equal(backend, tmp_path):
    items = [{"image": f"{backend}/a.png", "prompt": "p"},
             {"key": "k1", "instruction": "i"},
             {"image": "/abs/x.png", "instruction": "i", "key": "kk"},
             {"image": "b.png", "prompt": ""}]
    for item in items:
        for img_dir in (None, tmp_path):
            got = tmeta.resolve_item(item, img_dir=img_dir)
            assert got == jmeta.resolve_item(item, img_dir=img_dir)
            assert tmeta.item_key(item, got[0]) == jmeta.item_key(item,
                                                                  got[0])
    for bad in ({"prompt": "p"}, {"image": "a.png"}):
        with pytest.raises(KeyError):
            jmeta.resolve_item(bad)
        with pytest.raises(KeyError):
            tmeta.resolve_item(bad)
