"""The port's evaluation stack (`regione_tpu_torch.eval`: metrics, merge,
run_metrics, preprocess, viescore, run_viescore) against the JAX
package's (`regione_tpu.eval`), on the same inputs.

Every module here is numpy / host Python in both packages, so the bound is
equality: PSNR and SSIM exactly, metric.csv, merged_metric.txt, the score
CSVs and the preprocessed metadata.jsonl byte for byte, the parsed score
lists entry by entry, the same exceptions with the same messages.  LPIPS
and the pixel probe: tests/test_torch_eval_lpips.py.
"""

import csv
import json
import math
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from regione_tpu.eval import merge as jmerge
from regione_tpu.eval import metrics as jmetrics
from regione_tpu.eval import preprocess as jpre
from regione_tpu.eval import run_viescore as jrun_vie
from regione_tpu.eval import viescore as jvie
from regione_tpu_torch.eval import merge as tmerge
from regione_tpu_torch.eval import metrics as tmetrics
from regione_tpu_torch.eval import preprocess as tpre
from regione_tpu_torch.eval import run_metrics as trun_metrics
from regione_tpu_torch.eval import run_viescore as trun_vie
from regione_tpu_torch.eval import viescore as tvie


def _pairs(seed):
    rng = np.random.default_rng(seed)
    a8 = rng.integers(0, 256, (24, 20, 3)).astype(np.uint8)
    b8 = np.clip(a8.astype(int) + rng.integers(-40, 40, a8.shape), 0, 255
                 ).astype(np.uint8)
    af = rng.random((17, 23, 3))
    bf = np.clip(af + 0.05 * rng.standard_normal(af.shape), 0, 1)
    return (a8, b8, 255.0), (af, bf, 1.0), (a8[..., 0], b8[..., 0], 255.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_and_ssim_equal_the_jax_package(seed):
    for a, b, dr in _pairs(seed):
        assert tmetrics.psnr(a, b, dr) == jmetrics.psnr(a, b, dr)
        assert tmetrics.ssim(a, b, dr) == jmetrics.ssim(a, b, dr)
        assert tmetrics.psnr(a, a, dr) == float("inf")
        assert tmetrics.ssim(a, a, dr) == pytest.approx(1.0)
    x = np.random.default_rng(seed).random((9, 11))
    assert np.array_equal(tmetrics._uniform_filter(x, 7),
                          jmetrics._uniform_filter(x, 7))


def _result_roots(root, seed=2):
    """vanilla/ and regione/ roots of two tasks (one with a resized image
    and a non-image file), with time_consuming.json in both schemas."""
    rng = np.random.default_rng(seed)
    for ti, task in enumerate(("TE", "CR")):
        for name in ("vanilla", "regione"):
            (root / name / task / "generation").mkdir(parents=True)
        for k in range(2):
            img = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
            Image.fromarray(img).save(
                root / "vanilla" / task / "generation" / f"img_{k}.png")
            jit = np.clip(img.astype(int) + rng.integers(-9, 9, img.shape),
                          0, 255).astype(np.uint8)
            if ti == 1 and k == 1:
                jit = jit[:12, :14]          # resized to the vanilla shape
            Image.fromarray(jit).save(
                root / "regione" / task / "generation" / f"img_{k}.png")
        (root / "regione" / task / "generation" / "notes.txt").write_text("x")
        timing = ({"num_item": 2, "ave_time_consuming": 1.25,
                   "time_consuming_list": [1.0, 1.5]} if ti == 0 else
                  {"num_item": 2, "ave": 2.5, "list": [2.0, 3.0]})
        json.dump(timing, open(root / "regione" / task /
                               "time_consuming.json", "w"))
    return root / "vanilla", root / "regione"


def test_run_all_tasks_and_merge_write_the_same_bytes(tmp_path):
    van, reg = _result_roots(tmp_path / "src")
    roots = {}
    for name, metrics, merge in (("jax", jmetrics, jmerge),
                                 ("port", tmetrics, tmerge)):
        out = tmp_path / name
        shutil.copytree(reg, out)
        kw = {} if name == "jax" else {"device": "cpu"}
        res = metrics.run_all_tasks(str(van), str(out), with_lpips=False,
                                    **kw)
        roots[name] = (out, res, merge.merge_direction(str(out)))
    (jout, jres, jtext), (tout, tres, ttext) = roots["jax"], roots["port"]
    assert ttext == jtext and "Latency: 1.8750" in ttext
    for task in ("TE", "CR"):
        assert (tout / task / "metric.csv").read_bytes() == \
            (jout / task / "metric.csv").read_bytes()
        assert [r["file"] for r in tres[task]] == ["img_0.png", "img_1.png"]
    assert (tout / "merged_metric.txt").read_bytes() == \
        (jout / "merged_metric.txt").read_bytes()
    # the pretrain branch: identity metrics from the timing file alone
    for mod in (jmerge, tmerge):
        shutil.rmtree(tmp_path / "pre", ignore_errors=True)
        shutil.copytree(reg, tmp_path / "pre")
        got = mod.merge_direction(str(tmp_path / "pre"), is_pretrain=True)
        if mod is jmerge:
            want = got
    assert got == want and "PSNR: inf" in got and "Prompts: 4" in got


def test_save_results_to_csv_matches_byte_for_byte(tmp_path):
    rows = [{"file": "a.png", "psnr": 31.234567, "ssim": 0.912345,
             "lpips": float("nan")},
            {"file": "b.png", "psnr": float("inf"), "ssim": 1.0,
             "lpips": 0.123456}]
    jmetrics.save_results_to_csv(rows, str(tmp_path / "j" / "m.csv"))
    tmetrics.save_results_to_csv(rows, str(tmp_path / "t" / "m.csv"))
    assert (tmp_path / "t" / "m.csv").read_bytes() == \
        (tmp_path / "j" / "m.csv").read_bytes()
    assert next(csv.reader(open(tmp_path / "t" / "m.csv"))) == [
        "Filename", "PSNR", "SSIM", "LPIPS"]


@pytest.mark.parametrize("case", ["bad_metric_header", "bad_timing",
                                  "no_count"])
def test_merge_raises_the_same_errors(tmp_path, case):
    d = tmp_path / "bad" / "TE"
    d.mkdir(parents=True)
    if case == "bad_metric_header":
        (d / "metric.csv").write_text("name,quality\nimg.png,9\n")
    elif case == "bad_timing":
        json.dump({"n": 1, "mean_seconds": 9.9},
                  open(d / "time_consuming.json", "w"))
    else:
        json.dump({"ave": 2.0}, open(d / "time_consuming.json", "w"))
    errors = []
    for mod in (jmerge, tmerge):
        with pytest.raises(ValueError) as e:
            mod.merge_direction(str(tmp_path / "bad"))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_merge_reads_both_metric_csv_schemas(tmp_path):
    for name, hdr in (("ref", "Filename,PSNR,SSIM,LPIPS"),
                      ("old", "file,psnr,ssim,lpips")):
        d = tmp_path / name / "TE"
        d.mkdir(parents=True)
        (d / "metric.csv").write_text(
            f"{hdr}\nimg.png,30.0,0.9,0.1\nAVERAGE,30.0,0.9,0.1\n")
        json.dump({"num_item": 1, "ave_time_consuming": 2.0,
                   "time_consuming_list": [2.0]},
                  open(d / "time_consuming.json", "w"))
        want = jmerge.merge_direction(str(tmp_path / name))
        assert tmerge.merge_direction(str(tmp_path / name)) == want
        assert "PSNR: 30.0000" in want and "SSIM: 0.9000" in want


def test_run_metrics_cli_writes_the_jax_csvs(tmp_path, capsys):
    van, reg = _result_roots(tmp_path / "src", seed=5)
    res = trun_metrics.main(["--folder1", str(van), "--folder2", str(reg),
                             "--out_dir", str(tmp_path / "port"),
                             "--no_lpips", "--device", "cpu"])
    jmetrics.run_all_tasks(str(van), str(reg), str(tmp_path / "jax"),
                           with_lpips=False)
    for task in ("TE", "CR"):
        assert (tmp_path / "port" / task / "metric.csv").read_bytes() == \
            (tmp_path / "jax" / task / "metric.csv").read_bytes()
    assert sorted(res) == ["CR", "TE"]
    assert "TE: n=2" in capsys.readouterr().out


# -- VIEScore -----------------------------------------------------------------

# the sloppy-reply corpus of tests/test_eval.py (test_viescore_parse_*):
# (reply, n_expected, the accepted scores or None)
CORPUS = [
    ('{"score": [7, 8.5], "reasoning": "x"}', None, [7.0, 8.5]),
    ('||V^=^V||{"score": [6, 9], "reasoning": "ok"}||V^=^V||', None,
     [6.0, 9.0]),
    ('Sure! Here is my rating:\n{"score": [3, 4],\n'
     '"reasoning": "the\nedit is partial"}\nHope that helps.', None,
     [3.0, 4.0]),
    ('{"score": 7, "reasoning": "fine"}', None, [7.0]),
    ('{score: [5, 6], reasoning: ok}', None, [5.0, 6.0]),
    ('{"score": [5, 6], "reasoning": "ok",}', None, [5.0, 6.0]),
    ("{'score': [5, 6]}", None, None),
    ('{"score": [5, 6], "reasoning": \'fine\'}', None, [5.0, 6.0]),
    ('[6, 0]', None, [6.0, 0.0]),
    ('8', None, [8.0]),
    ('{"score": [10.3, 0]}', None, [10.0, 0.0]),
    ('{"score": [100, 5]}', None, None),
    ('{"score": [-3, 5]}', None, None),
    ("On a scale of 0 to 10, I would need to see the image.", None, None),
    ("no numbers here", None, None),
    ('{"reasoning": "forgot the scores"}', None, None),
    ('{"score": ["high", "low"]}', None, None),
    ('{"score": [true, false]}', None, None),
    ('{"score": [7]}', 2, None),
    ('[1, 2, 3]', 2, None),
    ('{"score": [7, 8]}', 2, [7.0, 8.0]),
    ('{"score": [NaN, 7]}', None, None),
    ('{"score": [Infinity, 7]}', None, None),
    ("", None, None),
    ("[oops", None, None),
]


def test_parse_scores_matches_the_jax_package_on_the_corpus():
    for reply, n, want in CORPUS:
        got = tvie.parse_scores(reply, n_expected=n)
        assert got == jvie.parse_scores(reply, n_expected=n) == want, reply
        assert tvie._fix_json(reply) == jvie._fix_json(reply)
    for raw in (3, 2.5, True, [1, "2"], [], [10.4], [-0.4], None, [1, 2]):
        for n in (None, 1, 2):
            assert tvie._coerce_score_list(raw, n) == \
                jvie._coerce_score_list(raw, n)


def test_prompts_and_delimiter_are_the_jax_package_s():
    assert tvie._SC_PROMPT == jvie._SC_PROMPT
    assert tvie._PQ_PROMPT == jvie._PQ_PROMPT
    assert tvie._DELIM == jvie._DELIM
    assert tvie.LOCAL_JUDGE_DEFAULTS == jvie.LOCAL_JUDGE_DEFAULTS


def _task(root, n=3, schema="ours"):
    task = root / "task"
    (task / "img").mkdir(parents=True)
    gen = root / "gen"
    gen.mkdir()
    with open(task / "metadata.jsonl", "w") as fh:
        for k in range(n):
            img = np.full((8, 8, 3), k * 40, np.uint8)
            Image.fromarray(img).save(task / "img" / f"k{k}.png")
            Image.fromarray(255 - img).save(gen / f"k{k}.png")
            item = ({"key": f"k{k}", "image": f"k{k}.png",
                     "prompt": f"edit {k}"} if schema == "ours" else
                    {"key": f"k{k}", "instruction": f"edit {k}",
                     "instruction_language": "en" if k else "cn"})
            fh.write(json.dumps(item) + "\n")
    return task, gen


@pytest.mark.parametrize("schema", ["ours", "reference"])
def test_run_task_and_statistics_match_with_the_dry_run_judge(tmp_path,
                                                              schema):
    """run_task (the CSV and its resume), analyze_scores and
    write_score_artifacts with DryRunBackbone: equal CSV bytes, statistics
    and artifact files."""
    task, gen = _task(tmp_path, schema=schema)
    outs = {}
    for name, mod in (("jax", jvie), ("port", tvie)):
        out_csv = tmp_path / name / "TE" / "dryrun_vie_score.csv"
        rows = mod.run_task(mod.VIEScore(mod.DryRunBackbone()), str(task),
                            str(gen), str(out_csv), workers=2)
        resumed = mod.run_task(None, str(task), str(gen), str(out_csv))
        stats = mod.write_score_artifacts([str(out_csv)],
                                          str(tmp_path / name), "dryrun")
        outs[name] = (out_csv.read_bytes(), rows, resumed, stats,
                      mod.analyze_scores([str(out_csv)], language=None))
    j, t = outs["jax"], outs["port"]
    assert t[0] == j[0]
    assert t[1] == j[1] and len(t[1]) == 3
    assert t[2] == j[2] and len(t[2]) == 3
    assert t[3] == j[3] and t[4] == j[4] and t[4]["n"] == 3
    for rel in ("dryrun_voe_score_merged.txt",
                "TE/dryrun_voe_score_mean.txt"):
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes()


def test_analyze_scores_reads_reference_csvs_like_the_jax_package(tmp_path):
    a = tmp_path / "ta" / "v.csv"
    b = tmp_path / "TE" / "gpt4o_vie_score.csv"
    a.parent.mkdir()
    b.parent.mkdir()
    a.write_text("key,sc,pq,o\nk0,2,2,2\nk1,8,6,\n")
    b.write_text("key,edited_image,instruction,sementics_score,"
                 "quality_score,instruction_language\n"
                 "a,a.png,edit,8.0,6.0,en\nb,b.png,bianji,2.0,2.0,cn\n")
    for lang in ("en", None, "cn"):
        assert tvie.analyze_scores([str(a), str(b)], language=lang) == \
            jvie.analyze_scores([str(a), str(b)], language=lang)
    bad = tmp_path / "bad.csv"
    bad.write_text("key,quality\nk,9\n")
    msgs = []
    for mod in (jvie, tvie):
        with pytest.raises(ValueError) as e:
            mod.analyze_scores([str(bad)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


class _Prose:
    def __init__(self):
        self.calls = 0

    def get_parsed_output(self, prompt, images):
        self.calls += 1
        return "on a scale of 0 to 10 this is hard to say"


def test_give_up_parsing_and_the_prose_judge_match(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    task, gen = _task(tmp_path, n=1)
    got = {}
    for name, mod in (("jax", jvie), ("port", tvie)):
        s = mod.VIEScore(_Prose())
        with pytest.raises(ValueError, match="unparseable"):
            s.evaluate([img, img], "edit")
        r = s.evaluate([img, img], "edit", give_up_parsing=True)
        judge = _Prose()
        rows = mod.run_task(mod.VIEScore(judge), str(task), str(gen),
                            str(tmp_path / name / "v.csv"), parse_tries=2)
        got[name] = (r, rows, judge.calls,
                     (tmp_path / name / "v.csv").read_bytes())
    assert got["port"] == got["jax"]
    r, rows, calls, _ = got["port"]
    assert r["guessed"] and r["sc"] == r["pq"] == 5.0
    assert int(rows[0]["guessed"]) == 1 and calls == 6


def test_retry_backoff_matches():
    for mod in (jvie, tvie):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("boom")
            return "ok"

        assert mod.process_with_retry(flaky, backoff=0.0) == "ok"
        assert len(calls) == 3
        with pytest.raises(ValueError):
            mod.process_with_retry(lambda: (_ for _ in ()).throw(
                ValueError("x")), no_retry=(ValueError,), backoff=0.0)
        with pytest.raises(ImportError):
            mod.process_with_retry(lambda: (_ for _ in ()).throw(
                ImportError("sdk")), backoff=0.0)
        with pytest.raises(RuntimeError):
            mod.process_with_retry(lambda: (_ for _ in ()).throw(
                RuntimeError("x")), max_tries=2, backoff=0.0)


def test_make_backbone_dispatch_matches(monkeypatch, tmp_path):
    """The dispatch table of tests/test_eval.py, with the local judges
    replaced; the port's local judges default to the card."""
    key = tmp_path / "keys.txt"
    key.write_text("sk-abc\n")
    seen = {}
    for name, mod in (("jax", jvie), ("port", tvie)):
        built = []

        class FakeLocal:
            def __init__(self, path, device="cpu", **kw):
                built.append(("local", path, device))

        class FakeMini:
            def __init__(self, path, device="cpu"):
                built.append(("mini", path, device))

        monkeypatch.setattr(mod, "LocalVLMBackbone", FakeLocal)
        monkeypatch.setattr(mod, "MiniCPMVBackbone", FakeMini)
        out = [type(mod.make_backbone("dryrun")).__name__]
        with pytest.raises(ValueError, match="unknown"):
            mod.make_backbone("nope")
        for b, kw in (("gpt4o", {}), ("gpt4v", {}),
                      ("gemini", {"model_name": "models/gemini-1.5-pro"}),
                      ("gemini", {})):
            bb = mod.make_backbone(b, key_path=str(key), **kw)
            out.append((b, bb.model_name, getattr(bb, "keys", None),
                        getattr(bb, "api_key", None)))
        for b in ("idefics2", "mantis", "qwen25vl"):
            mod.make_backbone(b)
        mod.make_backbone("minicpmv", vlm_path="/ckpt/minicpm")
        seen[name] = (out, built)
    (jout, jbuilt), (tout, tbuilt) = seen["jax"], seen["port"]
    assert tout == jout
    assert [b[:2] for b in tbuilt] == [b[:2] for b in jbuilt]
    assert {b[2] for b in tbuilt} == {"cuda"}
    assert {b[2] for b in jbuilt} == {"cpu"}


def test_openai_key_rotation_with_a_fake_client(tmp_path):
    key = tmp_path / "keys.txt"
    key.write_text("k1\nk2\n\n")
    img = np.zeros((4, 4, 3), np.uint8)
    got = {}
    for name, mod in (("jax", jvie), ("port", tvie)):
        b = mod.OpenAIBackbone(str(key), "gpt-4.1")
        used = []

        class Client:
            def __init__(self, key):
                self.chat = types.SimpleNamespace(
                    completions=types.SimpleNamespace(create=self.create))
                self.key = key

            def create(self, model, messages, max_tokens):
                used.append((self.key, model, max_tokens,
                             [c["type"] for c in messages[0]["content"]]))
                if self.key == "k1":
                    raise RuntimeError("rate limited")
                msg = types.SimpleNamespace(content='{"score": [7, 8]}')
                return types.SimpleNamespace(
                    choices=[types.SimpleNamespace(message=msg)])

        b._client = lambda: Client(b.keys[b.key_idx])
        reply = mod.process_with_retry(b.get_parsed_output, "rate", [img],
                                       backoff=0.0)
        got[name] = (reply, b.key_idx, used)
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ('{"score": [7, 8]}', 1)


def test_gemini_and_minicpm_protocols_match(monkeypatch):
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)
    img = np.zeros((4, 4, 3), np.uint8)

    class Blocked:
        @property
        def text(self):
            raise ValueError("blocked")

    class ChatModel:
        def chat(self, image, msgs, tokenizer, sampling):
            assert sampling is False and tokenizer == "tok"
            assert [c["type"] for c in msgs[0]["content"]] == [
                "image", "image", "text"]
            return '{"score": [6, 7]}'

    for mod in (jvie, tvie):
        with pytest.raises(AssertionError):
            mod.GeminiBackbone()
        g = mod.GeminiBackbone(api_key="k", model_name="gemini-1.5-flash")
        assert g._model is None and g.model_name == "gemini-1.5-flash"
        g._model = types.SimpleNamespace(generate_content=lambda c: Blocked())
        assert g.get_parsed_output("rate", [img]) == ""
        m = mod.MiniCPMVBackbone.__new__(mod.MiniCPMVBackbone)
        m.model, m.tokenizer = ChatModel(), "tok"
        assert mod.parse_scores(m.get_parsed_output("r", [img, img])) == [
            6.0, 7.0]


def test_local_judges_default_to_the_card():
    import inspect
    for fn in (tvie.LocalVLMBackbone.__init__, tvie.MiniCPMVBackbone.__init__,
               tvie.make_backbone):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_run_viescore_cli_matches_the_jax_cli(tmp_path, capsys):
    """Both CLIs over the same task with the dry-run judge: the same CSV,
    artifacts and printed statistics (the port's --device is unused by
    the dry-run judge)."""
    task, gen = _task(tmp_path / "data", schema="reference")
    bench = tmp_path / "data"
    for name, main, extra in (("jax", jrun_vie.main, []),
                              ("port", trun_vie.main, ["--device", "cpu"])):
        root = tmp_path / name / "task"
        root.mkdir(parents=True)
        shutil.copytree(gen, root / "generation")
        main(["--data_dir", str(bench), "--gen_root", str(tmp_path / name),
              "--backbone", "dryrun", "--workers", "2", "--language", "all"]
             + extra)
    out = capsys.readouterr().out
    j, t = (tmp_path / n / "task" / "dryrun_vie_score.csv"
            for n in ("jax", "port"))
    assert t.read_bytes() == j.read_bytes()
    assert (tmp_path / "port" / "dryrun_voe_score_merged.txt").read_bytes() \
        == (tmp_path / "jax" / "dryrun_voe_score_merged.txt").read_bytes()
    halves = out.split("task: 3 scored")
    assert len(halves) == 3 and halves[1] == halves[2]


# -- preprocess ----------------------------------------------------------------

@pytest.mark.parametrize("bench", ["gedit", "kontext"])
def test_preprocess_writes_the_jax_package_s_files(tmp_path, monkeypatch,
                                                   bench):
    img = Image.fromarray(np.arange(192, dtype=np.uint8).reshape(8, 8, 3))
    if bench == "gedit":
        ds = [{"key": "k7", "task_type": "text_change",
               "instruction": "swap the words", "instruction_language": "en",
               "input_image": img},
              {"key": "k8", "task_type": "text_change",
               "instruction": "huan ci", "instruction_language": "cn",
               "input_image": img},
              {"task_type": "color_alter", "instruction": "make it red",
               "input_image": img},
              {"key": "k9", "task_type": "unknown", "instruction": "x",
               "input_image": img}]
    else:
        ds = [{"category": "Text Editing", "instruction": "swap",
               "image": img},
              {"category": "Style Reference", "instruction": "ghibli",
               "image": img},
              {"category": "Text Editing", "instruction": "again",
               "image": img},
              {"category": "Other", "instruction": "x", "image": img}]
    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=lambda *a, **k: ds))
    counters = {}
    for name, mod in (("jax", jpre), ("port", tpre)):
        proc = (mod.GEditBenchProcessor if bench == "gedit"
                else mod.KontextBenchProcessor)
        counters[name] = proc(str(tmp_path / "src"),
                              str(tmp_path / name)).process()
    assert counters["port"] == counters["jax"]
    files = {name: sorted(p.relative_to(tmp_path / name)
                          for p in (tmp_path / name).rglob("*")
                          if p.is_file()) for name in ("jax", "port")}
    assert files["port"] == files["jax"] and files["port"]
    for rel in files["port"]:
        assert (tmp_path / "port" / rel).read_bytes() == \
            (tmp_path / "jax" / rel).read_bytes(), rel
    assert tpre.KONTEXT_CATEGORY_MAP == jpre.KONTEXT_CATEGORY_MAP
    assert tpre.GEDIT_TASK_TYPES == jpre.GEDIT_TASK_TYPES


def test_preprocess_main_skips_missing_dumps(tmp_path, capsys):
    tpre.main(["--kontext_dir", str(tmp_path / "none"), "--gedit_dir",
               str(tmp_path / "none2"), "--out_dir", str(tmp_path / "o")])
    assert capsys.readouterr().out == "" and not (tmp_path / "o").exists()


def test_overall_task_mean_is_unweighted_over_tasks(tmp_path):
    a = tmp_path / "ta" / "v.csv"
    b = tmp_path / "tb" / "v.csv"
    for p, rows in ((a, [(2, 2, 2)]), (b, [(8, 8, 8)] * 3)):
        p.parent.mkdir()
        with open(p, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["key", "sc", "pq", "o"])
            w.writeheader()
            for i, (sc, pq, o) in enumerate(rows):
                w.writerow({"key": f"k{i}", "sc": sc, "pq": pq, "o": o})
    stats = tvie.analyze_scores([str(a), str(b)])
    assert stats == jvie.analyze_scores([str(a), str(b)])
    assert stats["overall"]["o"] == pytest.approx((2 + 8 * 3) / 4)
    assert stats["overall_task_mean"]["o"] == pytest.approx(5.0)
    assert math.isclose(stats["overall_task_mean"]["sc"], 5.0)
