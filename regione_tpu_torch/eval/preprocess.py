"""Benchmark dataset preprocessor: Kontext-Bench + GEdit-Bench.

The port's copy of `regione_tpu/eval/preprocess.py` (the reference's
data/preprocess.py:47-157): reorganizes the two HF benchmark dumps into
data/Processed/<bench>/<task>/{img/*.png, metadata.jsonl} with the same
task maps — Kontext's five category abbreviations (preprocess.py:50-56)
and GEdit's eleven task types with the English-language filter
(preprocess.py:110-114).

The raw datasets are fetched by the user (the reference's
script/load_data.sh uses huggingface-cli); this module only reshapes local
dumps, and imports without the `datasets` package (a lazy import).
"""

from __future__ import annotations

import json
from pathlib import Path

# reference data/preprocess.py:50-56
KONTEXT_CATEGORY_MAP = {
    "Character Reference": "CR",
    "Style Reference": "SR",
    "Instruction Editing (Global)": "IEG",
    "Text Editing": "TE",
    "Instruction Editing (Local)": "IEL",
}

# reference data/preprocess.py:110-114
GEDIT_TASK_TYPES = [
    "background_change", "color_alter", "material_alter", "motion_change",
    "ps_human", "style_change", "subject-add", "subject-remove",
    "subject-replace", "text_change", "tone_transfer",
]


class KontextBenchProcessor:
    """reference data/preprocess.py:47-104."""

    def __init__(self, src_dir: str, out_dir: str):
        self.src = Path(src_dir)
        self.out = Path(out_dir)

    def process(self):
        from datasets import load_dataset  # lazy: big optional dep
        ds = load_dataset(str(self.src), split="test")
        counters: dict[str, int] = {}
        for item in ds:
            cat = item.get("category")
            abbr = KONTEXT_CATEGORY_MAP.get(cat)
            if abbr is None:
                continue
            task_dir = self.out / "Kontext-Bench" / abbr
            (task_dir / "img").mkdir(parents=True, exist_ok=True)
            idx = counters.get(abbr, 0)
            counters[abbr] = idx + 1
            key = f"{abbr}_{idx:04d}"
            img_name = f"{key}.png"
            item["image"].save(task_dir / "img" / img_name)
            with open(task_dir / "metadata.jsonl", "a") as fh:
                # "instruction"/"instruction_language" so the REFERENCE
                # entry scripts (which index data["instruction"], e.g.
                # src/Qwen-Image-Edit-2509/main.py:114) run unchanged on
                # our preprocessed dirs; "prompt" is our short alias
                fh.write(json.dumps(
                    {"key": key, "image": img_name,
                     "prompt": item["instruction"],
                     "instruction": item["instruction"],
                     "instruction_language": "en"}) + "\n")
        return counters


class GEditBenchProcessor:
    """reference data/preprocess.py:107-157 (English subset)."""

    def __init__(self, src_dir: str, out_dir: str, language: str = "en"):
        self.src = Path(src_dir)
        self.out = Path(out_dir)
        self.language = language

    def process(self):
        from datasets import load_dataset
        ds = load_dataset(str(self.src), split="train")
        counters: dict[str, int] = {}
        for item in ds:
            task = item.get("task_type")
            if task not in GEDIT_TASK_TYPES:
                continue
            if item.get("instruction_language", "en") != self.language:
                continue
            task_dir = self.out / "GEdit-Bench" / task
            (task_dir / "img").mkdir(parents=True, exist_ok=True)
            key = item.get("key") or f"{task}_{counters.get(task, 0):04d}"
            counters[task] = counters.get(task, 0) + 1
            img_name = f"{key}.png"
            item["input_image"].save(task_dir / "img" / img_name)
            with open(task_dir / "metadata.jsonl", "a") as fh:
                fh.write(json.dumps(
                    {"key": key, "image": img_name,
                     "prompt": item["instruction"],
                     "instruction": item["instruction"],
                     "instruction_language": self.language}) + "\n")
        return counters


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--kontext_dir", default="data/Kontext-Bench")
    ap.add_argument("--gedit_dir", default="data/GEdit-Bench")
    ap.add_argument("--out_dir", default="data/Processed")
    ap.add_argument("--language", default="en",
                    help="GEdit instruction-language filter (the reference "
                         "hardcodes en, data/preprocess.py:116; GEdit also "
                         "ships cn — pair a non-en sweep with "
                         "run_viescore --language)")
    args = ap.parse_args(argv)
    if Path(args.kontext_dir).exists():
        print("Kontext:", KontextBenchProcessor(args.kontext_dir, args.out_dir).process())
    if Path(args.gedit_dir).exists():
        print("GEdit:", GEditBenchProcessor(args.gedit_dir, args.out_dir,
                                            language=args.language).process())


if __name__ == "__main__":
    main()
