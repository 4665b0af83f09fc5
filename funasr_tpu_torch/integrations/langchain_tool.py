"""Agent-framework integrations over the port's ``AutoModel`` (a copy of
``funasr_tpu/integrations/langchain_tool.py``; counterpart of the reference's L7 client
integrations: langchain / dify / OpenAI function-calling).

``FunASRTool`` is framework-agnostic: it exposes ``run`` (audio path/URL ->
text), a LangChain ``Tool`` adapter (lazy import, optional dep), and an OpenAI
function spec usable by dify or any function-calling agent. Dify can also call
the OpenAI-compatible HTTP endpoint directly
(``funasr-tpu-torch-server`` -> POST /v1/audio/transcriptions).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class FunASRTool:
    """Speech-to-text tool over ``AutoModel`` (VAD + ASR + punc pipeline)."""

    name = "transcribe_audio"
    description = ("Transcribe speech audio to text. Input: a path or URL to "
                   "an audio file (wav/mp3/flac). Output: the transcript.")

    def __init__(self, model: Optional[str] = None, auto_model=None, **kwargs):
        if auto_model is None:
            from funasr_tpu_torch.auto.auto_model import AutoModel
            auto_model = AutoModel(model=model, **kwargs)
        self.auto_model = auto_model

    def run(self, audio: str, **kwargs) -> str:
        results = self.auto_model.generate(input=audio, **kwargs)
        return " ".join(r.get("text", "") for r in results).strip()

    # -- LangChain ------------------------------------------------------------

    def as_langchain_tool(self):
        """Returns a ``langchain_core.tools.Tool`` (requires langchain-core)."""
        from langchain_core.tools import Tool
        return Tool(name=self.name, description=self.description,
                    func=self.run)

    # -- OpenAI function calling / dify ---------------------------------------

    def as_openai_function(self) -> Dict[str, Any]:
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": {
                    "type": "object",
                    "properties": {
                        "audio": {
                            "type": "string",
                            "description": "Path or URL of the audio file",
                        },
                    },
                    "required": ["audio"],
                },
            },
        }

    def call_openai_function(self, arguments: Dict[str, Any]) -> str:
        return self.run(arguments["audio"])
