"""Caption structurizer — preprocess/n2s_by_openai.py / struct_to_natural.py
equivalents, usable offline AND online: the port's own copy of
maa3_tpu/data/structurize.py (standard library only). The live client
reaches only the endpoint it is given; the tests run it against a loopback
stub.

The reference calls GPT-3.5 to turn natural captions into the structured
`<event& time>@<event& time>` form and back. This module provides:
- `struct_to_natural`: deterministic inverse (string surgery, no LLM)
- `natural_to_struct`: the trivial `<caption& all>` fallback the datasets use
  when no structurizer ran, plus an optional pluggable LLM callable
- `heuristic_natural_to_struct`: deterministic rule-based n2s
- `OpenAIStructurizer`: a live chat-completions client (stdlib urllib, any
  OpenAI-compatible endpoint via OPENAI_BASE_URL) reproducing the reference's
  few-shot prompt, temperature-0 request and 'sorry'-fallback semantics
  (preprocess/n2s_by_openai.py:7-35), with retries the reference lacks
- `structurize_tsv`: the reference's resumable TSV batch workflow
  (n2s_by_openai.py:44-81): per-row progress `.txt`, then a `_struct.tsv`
  with the new column.
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from typing import Callable, List, Optional

PROMPT = (
    "Convert the natural audio caption into the structured form "
    "'<event& time>@<event& time>' where time is one of all/start/mid/end "
    "and events are atomic sound events, preserving order."
)


def natural_to_struct(caption: str,
                      llm: Optional[Callable[[str], str]] = None) -> str:
    """Natural -> structured. Without an LLM endpoint, the whole caption is a
    single all-span event — exactly what the training TSVs fall back to."""
    caption = caption.strip().rstrip(".")
    if not caption:
        return ""
    if llm is not None:
        return llm(f"{PROMPT}\n\n{caption}")
    return f"<{caption}& all>"


def struct_to_natural(struct: str) -> str:
    """'<a& all>@<b& end>' -> 'a, then b' (struct_to_natural.py semantics:
    strip markers, join events in order)."""
    events: List[str] = []
    for part in struct.split("@"):
        part = part.strip()
        if part.startswith("<"):
            part = part[1:]
        if part.endswith(">"):
            part = part[:-1]
        event = part.split("&")[0].strip()
        if event:
            events.append(event)
    if not events:
        return ""
    if len(events) == 1:
        return events[0]
    return ", then ".join(events)


# ---------------------------------------------------------------------------
# Deterministic heuristic structurizer (offline n2s)
# ---------------------------------------------------------------------------
#
# The reference's natural->struct direction calls GPT-3.5
# (preprocess/n2s_by_openai.py:7-35). In a zero-egress environment this
# heuristic covers the same caption patterns deterministically, following
# the reference prompt's own examples: sequential connectives split events
# over start/mid/end, simultaneous connectives share the attachment's span,
# a single event spans "all".

_SEQUENTIAL = (" followed by ", ", then ", " and then ", " then ",
               " after which ")
_SIMULTANEOUS = (" while ", " as ", " with ")


def _split_first(text: str, seps) -> Optional[tuple]:
    """Earliest occurrence of any separator: (before, sep, after) or None."""
    best = None
    for sep in seps:
        i = text.lower().find(sep)
        if i >= 0 and (best is None or i < best[0]):
            best = (i, sep)
    if best is None:
        return None
    i, sep = best
    return text[:i], sep, text[i + len(sep):]


def heuristic_natural_to_struct(caption: str) -> str:
    """Rule-based natural -> '<event& time>@...' (no LLM, deterministic).

    'train passing followed by short honks' -> '<train passing& all>@'
    '<short honks& end>'; simultaneous clauses inherit their anchor's time;
    captions with no recognized connective become one all-span event.
    """
    caption = caption.strip().rstrip(".")
    if not caption:
        return ""

    # 1. split into sequential groups
    groups: List[str] = []
    rest = caption
    while True:
        hit = _split_first(rest, _SEQUENTIAL)
        if hit is None:
            groups.append(rest)
            break
        before, _, after = hit
        groups.append(before)
        rest = after

    # 2. time tag per group (mirrors the reference prompt's examples)
    if len(groups) == 1:
        times = ["all"]
    elif len(groups) == 2:
        times = ["all", "end"]
    else:
        times = ["start"] + ["mid"] * (len(groups) - 2) + ["end"]

    # 3. within a group, simultaneous clauses share the group's time
    events: List[tuple] = []
    for group, t in zip(groups, times):
        rest = group
        while True:
            hit = _split_first(rest, _SIMULTANEOUS)
            if hit is None:
                part = rest.strip(" ,")
                if part:
                    events.append((part, t))
                break
            before, _, after = hit
            part = before.strip(" ,")
            if part:
                events.append((part, t))
            rest = after

    return "@".join(f"<{e}& {t}>" for e, t in events)


# ---------------------------------------------------------------------------
# Live LLM structurizer (OpenAI-compatible chat completions)
# ---------------------------------------------------------------------------

# The reference's exact few-shot prompt (preprocess/n2s_by_openai.py:12-29),
# reproduced verbatim so a live run yields the same caption distribution.
N2S_FEWSHOT_PROMPT = (
    "I want to know what sound might be in the given scene and you need to "
    "give me the results in the following format:                "
    "Question: A bird sings on the river in the morning, a cow passes by and "
    "scares away the bird.                "
    "Answer: <running water& all>@<birds chriping& start>@<cow footsteps& "
    "mid>@<birds flying away& end>.                "
    "Question: cellphone ringing a variety of tones followed by a loud "
    "explosion and fire crackling as a truck engine runs idle                "
    "Answer: <variety cellphone ringing tones& start>@<loud explosion& end>"
    "@<fire crackling& end>@<truck engine idle& end>                "
    "Question: Train passing followed by short honks three times                 "
    "Answer: <train passing& all>@<short honks three times& end>                "
    "All indicates the sound exists in the whole scene                 "
    "Start, mid, end indicates the time period the sound appear.                "
    "Question: {caption}                 Answer:"
)


class OpenAIStructurizer:
    """Natural->structured caption via a live chat-completions endpoint.

    Reproduces preprocess/n2s_by_openai.py:get_struct: same few-shot prompt,
    temperature 0.0, and the same 'sorry'-in-answer fallback to a single
    all-span event (the reference emits `<caption, all>` there — a typo for
    its own `& ` separator; we emit the consistent `<caption& all>` so the
    fallback parses like every other struct caption). Adds what a production
    client needs and the reference lacks: bounded retries with backoff on
    transport/5xx errors, a request timeout, and an endpoint override
    (OPENAI_BASE_URL) so any OpenAI-compatible server works.
    """

    def __init__(self, api_key: Optional[str] = None,
                 base_url: Optional[str] = None,
                 model: str = "gpt-3.5-turbo",
                 timeout_s: float = 60.0, max_retries: int = 3,
                 retry_backoff_s: float = 2.0):
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = (base_url or os.environ.get(
            "OPENAI_BASE_URL", "https://api.openai.com/v1")).rstrip("/")
        self.model = model
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s

    def _post(self, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"},
            method="POST")
        last: Optional[Exception] = None
        for attempt in range(self.max_retries):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                    return json.loads(r.read().decode("utf-8"))
            except urllib.error.HTTPError as e:
                last = e
                if e.code < 500:  # auth/validation: retrying cannot help
                    raise
            except Exception as e:  # URLError, timeout, bad JSON
                last = e
            if attempt + 1 < self.max_retries:
                time.sleep(self.retry_backoff_s * (2 ** attempt))
        raise RuntimeError(
            f"structurizer endpoint failed after {self.max_retries} "
            f"attempts: {last!r}")

    def __call__(self, caption: str) -> str:
        resp = self._post({
            "model": self.model,
            "messages": [{"role": "user",
                          "content": N2S_FEWSHOT_PROMPT.format(
                              caption=caption)}],
            "temperature": 0.0,
        })
        answer = resp["choices"][0]["message"]["content"].strip()
        if "sorry" in answer.lower():  # refusal fallback (n2s_by_openai.py:62)
            return f"<{caption.lower()}& all>"
        return answer


def structurize_tsv(tsv_path: str, structurize: Callable[[str], str],
                    out_dir: Optional[str] = None,
                    caption_column: str = "caption") -> str:
    """Resumable TSV batch structurization (n2s_by_openai.py:44-81).

    Streams per-row results to `<name>.txt` ('index\\tstruct' lines, flushed
    per row) so an interrupted run resumes where it stopped, then joins them
    back as a `struct_cap` column into `<name>_struct.tsv`. Unlike the
    reference (bare `except: print("error")` forever-loop), a row that still
    fails after the client's retries falls back to the offline single-event
    struct so the batch always terminates with a complete column.
    Returns the output TSV path.
    """
    import csv

    name = os.path.basename(tsv_path)[:-4]
    out_dir = out_dir or os.path.dirname(os.path.abspath(tsv_path))
    progress_path = os.path.join(out_dir, f"{name}.txt")
    out_path = os.path.join(out_dir, f"{name}_struct.tsv")

    with open(tsv_path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))

    id2struct = {}
    if os.path.exists(progress_path):  # resume
        with open(progress_path) as f:
            for line in f:
                if "\t" in line:
                    idx, struct = line.rstrip("\n").split("\t", 1)
                    id2struct[int(idx)] = struct

    with open(progress_path, "a") as prog:
        for i, row in enumerate(rows):
            if i in id2struct:
                continue
            caption = row.get(caption_column, "") or ""
            try:
                struct = structurize(caption)
            except Exception:
                struct = natural_to_struct(caption)
            id2struct[i] = struct
            prog.write(f"{i}\t{struct}\n")
            prog.flush()

    fieldnames = (list(rows[0].keys()) if rows else [caption_column])
    if "struct_cap" not in fieldnames:
        fieldnames = fieldnames + ["struct_cap"]
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames, delimiter="\t")
        w.writeheader()
        for i, row in enumerate(rows):
            row = dict(row)
            row["struct_cap"] = id2struct.get(i, "")
            w.writerow(row)
    return out_path
