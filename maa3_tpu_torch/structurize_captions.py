"""Structure a manifest's captions on the port (the flags of
scripts/structurize_captions.py; preprocess/n2s_by_openai.py's job):

    python -m maa3_tpu_torch.structurize_captions --tsv_path in.tsv [--out out.tsv]
        [--llm-cmd CMD | --openai [--base_url URL] [--model NAME]]

Default: the deterministic heuristic (data/structurize.py) writes a
`caption` column from `ori_cap` into --out (default <tsv>.struct.tsv).
--llm-cmd runs a local command through the shell for each caption, the
few-shot prompt and caption on its stdin, its stdout the structured
caption (each call limited to 300 s). --openai posts to the
OpenAI-compatible chat-completions endpoint of --base_url (else
OPENAI_BASE_URL, else OpenAI's) with OPENAI_API_KEY, resumably, into
<name>_struct.tsv beside --out (data/structurize.structurize_tsv).
"""

from __future__ import annotations

import argparse
import csv
import os
import subprocess

from maa3_tpu_torch.data.structurize import (OpenAIStructurizer,
                                             heuristic_natural_to_struct,
                                             natural_to_struct, structurize_tsv)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tsv_path", required=True)
    ap.add_argument("--out", default="", help="default: <tsv>.struct.tsv")
    ap.add_argument("--llm-cmd", default="",
                    help="shell command reading the prompt on stdin and writing "
                         "the struct caption to stdout")
    ap.add_argument("--openai", action="store_true",
                    help="use a live OpenAI-compatible endpoint (resumable)")
    ap.add_argument("--model", default="gpt-3.5-turbo")
    ap.add_argument("--base_url", default="", help="override OPENAI_BASE_URL")
    ap.add_argument("--caption_column", default="ori_cap")
    return ap.parse_args(argv)


def main(argv=None) -> str:
    opt = parse_args(argv)
    if opt.openai:
        client = OpenAIStructurizer(base_url=opt.base_url or None, model=opt.model)
        out = structurize_tsv(opt.tsv_path, client,
                              out_dir=os.path.dirname(opt.out) or None,
                              caption_column=opt.caption_column)
        print(f"wrote {out}")
        return out

    llm = None
    if opt.llm_cmd:
        def llm(prompt):
            proc = subprocess.run(opt.llm_cmd, shell=True, input=prompt,
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"llm-cmd failed: {proc.stderr[-500:]}")
            return proc.stdout.strip()

    out_path = opt.out or opt.tsv_path.rsplit(".", 1)[0] + ".struct.tsv"
    with open(opt.tsv_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE, quotechar=None)
        rows = [dict(r) for r in reader]
        fields = list(reader.fieldnames or [])
    if "caption" not in fields:
        fields.append("caption")

    for i, row in enumerate(rows):
        cap = row.get("ori_cap", "")
        row["caption"] = (natural_to_struct(cap, llm) if llm
                          else heuristic_natural_to_struct(cap))
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{len(rows)}", flush=True)

    with open(out_path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=fields, delimiter="\t", quoting=csv.QUOTE_NONE,
                           quotechar=None, lineterminator="\n")
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out_path} ({len(rows)} rows)")
    return out_path


if __name__ == "__main__":
    main()
