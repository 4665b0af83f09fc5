"""Fun-ASR (LLM-ASR) dataset helpers: multi-context prompt builders and the
OpenAI-format chat index (a copy of ``funasr_tpu/datasets/fun_asr_datasets.py``; FunASR
``funasr/datasets/fun_asr_datasets/multicontext_prompt.py:9,245`` (MultiContextPrompt /
MultiContextPromptNew — context-aware instruction prompts with negative-hotword
sampling, drawn from ``numpy``'s and ``random``'s global generators as in JAX) and
``funasr/datasets/openai_datasets/{datasets,index_ds}.py`` (chat-format jsonl with
{"role","content"} turns, audio referenced as {"audio": path}).
"""

from __future__ import annotations

import json
import random
import re
from typing import Dict, List, Optional

import numpy as np

from funasr_tpu_torch.datasets.audio_datasets.index_ds import IndexDSJsonl
from funasr_tpu_torch.register import tables


def detect_language(text) -> str:
    """'zh' if CJK dominates (>30% and more than latin), else 'en'
    (reference ``multicontext_prompt.py:71-100``)."""
    if isinstance(text, list):
        text = " ".join(text)
    zh_len = sum(len(m) for m in re.findall(r"[一-鿿]+", text))
    en_len = sum(len(m) for m in re.findall(r"[A-Za-z]+", text))
    if len(text) == 0:
        return "zh"
    return "zh" if zh_len > en_len and zh_len / len(text) > 0.3 else "en"


@tables.register("prompt_classes", "MultiContextPrompt")
class MultiContextPrompt:
    CONTEXT_TEMPLATES = {
        "en": {
            "header": ("Please combine the context information provided below "
                       "to complete the speech transcription task more "
                       "accurately. If there is no relevant information, we "
                       "will leave it blank.\n"),
            "fields": {
                "hist_context": "Historical transcription: {hist_context}\n",
                "one_pass_result": "One-pass result: {one_pass_result}\n",
                "hotwords": "Hotword list: {hotwords}\n",
            },
        },
        "zh": {
            "header": ("请结合下面提供的上下文信息，更加准确地完成语音转写任务。"
                       "如果没有相关信息，我们会留空。\n"),
            "fields": {
                "hist_context": "历史转写结果：{hist_context}\n",
                "one_pass_result": "一遍解码结果：{one_pass_result}\n",
                "hotwords": "热词列表：{hotwords}\n",
            },
        },
    }

    def __init__(self, use_hist: bool = True, use_one_pass_result: bool = True,
                 use_hotwords: bool = True, use_asr_hotwords: bool = True,
                 use_multi_lingual_prompt: bool = True, **kwargs):
        self.use_hist = use_hist
        self.use_one_pass_result = use_one_pass_result
        self.use_hotwords = use_hotwords
        self.use_asr_hotwords = use_asr_hotwords
        self.use_multi_lingual_prompt = use_multi_lingual_prompt
        self.neg_lists: Dict[str, List[str]] = {}
        for lang, key in (("zh", "chinese_hotwords_list"),
                          ("en", "english_hotwords_list")):
            path = kwargs.get(key)
            if path:
                with open(path, encoding="utf-8") as f:
                    self.neg_lists[lang] = f.read().strip().split("\n")
        self.max_neg = kwargs.get("max_neg_hotwords_num", 900)
        self.min_neg = kwargs.get("min_neg_hotwords_num", 0)

    def _sample_negatives(self, pool: List[str]) -> List[str]:
        hi = min(self.max_neg, len(pool)) if self.max_neg > -1 else len(pool)
        n = np.random.randint(self.min_neg, hi + 1) if self.min_neg < hi else hi
        if n <= 0:
            return []
        return list(np.random.choice(pool, n, replace=False))

    def _context_lines(self, item: Dict, template: Dict,
                       with_negatives: bool) -> List[str]:
        lines = []
        if self.use_hist and item.get("hist_context"):
            lines.append(template["fields"]["hist_context"].format(
                hist_context=item["hist_context"]))
        if self.use_one_pass_result and item.get("one_pass_result"):
            lines.append(template["fields"]["one_pass_result"].format(
                one_pass_result=item["one_pass_result"]))
        hotwords = None
        if self.use_hotwords and item.get("hotwords"):
            hotwords = item["hotwords"]
        if self.use_asr_hotwords and item.get("asr_hotwords"):
            hotwords = item["asr_hotwords"]
        if hotwords:
            pos = hotwords if isinstance(hotwords, list) else hotwords.split(", ")
            if with_negatives:
                pool = self.neg_lists.get(detect_language(hotwords))
                neg = self._sample_negatives(pool) if pool else []
                merged = pos + neg
                random.shuffle(merged)
            else:
                merged = pos
            lines.append(template["fields"]["hotwords"].format(
                hotwords=", ".join(merged)))
        return lines

    def get_prompt(self, item: Dict, language: str) -> str:
        """Training prompt (negative hotwords mixed in to teach rejection)."""
        template = self.CONTEXT_TEMPLATES[language]
        lines = self._context_lines(item, template, with_negatives=True)
        return template["header"] + ("".join(lines) if lines else "\n\n\n")

    def get_inference_prompt(self, item: Dict, language: str = "zh") -> str:
        template = self.CONTEXT_TEMPLATES[language]
        lines = self._context_lines(item, template, with_negatives=False)
        return template["header"] + ("".join(lines) if lines else "\n\n\n")


@tables.register("prompt_classes", "MultiContextPromptNew")
class MultiContextPromptNew(MultiContextPrompt):
    """Markdown-flavored template revision (reference
    ``multicontext_prompt.py:245``)."""

    CONTEXT_TEMPLATES = {
        "en": {
            "header": ("Please combine the context information to complete the "
                       "speech transcription task more accurately. If there is "
                       "no relevant information, we will leave it blank.\n\n"),
            "context_header": "**Context:**\n",
            "fields": {
                "hist_context": "Historical transcription: {hist_context}\n",
                "one_pass_result": "One-pass result: {one_pass_result}\n",
                "hotwords": "Hotword list: {hotwords}\n",
            },
        },
        "zh": {
            "header": ("请结合上下文信息，更加准确地完成语音转写任务。"
                       "如果没有相关信息，我们会留空。\n\n"),
            "context_header": "**上下文：**\n",
            "fields": {
                "hist_context": "历史转写结果：{hist_context}\n",
                "one_pass_result": "一遍解码结果：{one_pass_result}\n",
                "hotwords": "热词列表：{hotwords}\n",
            },
        },
    }

    def get_prompt(self, item: Dict, language: str) -> str:
        template = self.CONTEXT_TEMPLATES[language]
        lines = self._context_lines(item, template, with_negatives=True)
        body = (template["context_header"] + "".join(lines)) if lines else "\n"
        return template["header"] + body

    def get_inference_prompt(self, item: Dict, language: str = "zh") -> str:
        template = self.CONTEXT_TEMPLATES[language]
        lines = self._context_lines(item, template, with_negatives=False)
        body = (template["context_header"] + "".join(lines)) if lines else "\n"
        return template["header"] + body


@tables.register("index_ds_classes", "OpenAIIndexDSJsonl")
class OpenAIIndexDSJsonl(IndexDSJsonl):
    """jsonl where each line is {"messages": [{"role","content"}...]} with audio
    turns as {"audio": path} content items (reference openai_datasets/index_ds)."""

    def __init__(self, path, **kwargs):
        self.contents = []
        paths = path if isinstance(path, (list, tuple)) else [path]
        for p in paths:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    obj = json.loads(line)
                    msgs = obj.get("messages", obj.get("conversation", []))
                    audio, text = None, ""
                    for m in msgs:
                        content = m.get("content")
                        if isinstance(content, list):
                            for c in content:
                                if isinstance(c, dict) and "audio" in c:
                                    audio = c["audio"]
                        elif m.get("role") == "assistant" and \
                                isinstance(content, str):
                            text = content
                    self.contents.append({
                        "source": audio or obj.get("source", ""),
                        "target": text or obj.get("target", ""),
                        "source_len": int(obj.get("source_len", 1)),
                        "target_len": int(obj.get("target_len",
                                                  max(len(text), 1))),
                        "key": obj.get("key"),
                        "messages": msgs,
                    })
