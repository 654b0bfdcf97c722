"""Conversation templates for graph-LLM chat (counterpart of
`gammagl_tpu/utils/conversation.py`; pure Python).

Reference: gammagl/utils/conversation.py:1-419 (itself from the public
FastChat/LLaVA template system): five separator styles, ``<graph>``
placeholder normalization (plain and mmtag variants), the template
registry GraphGPT/LLaGA select from, and the copy()/dict() protocol.
Every template renders the JAX package's prompt strings character for
character; like it, the reference's canned few-shot example inside
``conv_vicuna_v0`` is an empty history (GraphGPT/LLaGA train with
graphchat_v1 / llaga_llama_2 / v1, none of which carry canned history).
"""

import dataclasses
from enum import Enum, auto
from typing import List, Tuple

__all__ = ["SeparatorStyle", "Conversation", "conv_templates",
           "default_conversation", "get_conv_template"]


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


@dataclasses.dataclass
class Conversation:
    """Running chat history + the rendering rules for one prompt format."""

    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = None
    version: str = "Unknown"
    skip_next: bool = False

    # -- graph placeholder normalization (reference get_prompt head) ------
    def _normalized_messages(self):
        msgs = self.messages
        if msgs and isinstance(msgs[0][1], tuple):
            msgs = [list(m) for m in self.messages]
            role0, payload = msgs[0]
            text = payload[0].replace("<graph>", "").strip()
            if "mmtag" in self.version:
                msgs[0] = [role0, text]
                msgs.insert(0, [self.roles[0], "<Graph><graph></Graph>"])
                msgs.insert(1, [self.roles[1], "Received."])
            else:
                msgs[0] = [role0, "<graph>\n" + text]
        return msgs

    @staticmethod
    def _text(message):
        return message[0] if isinstance(message, tuple) else message

    def get_prompt(self):
        msgs = self._normalized_messages()
        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in msgs:
                out += (f"{role}: {self._text(message)}{self.sep}"
                        if message else f"{role}:")
            return out
        if style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2 or "")
            out = self.system + seps[0]
            for i, (role, message) in enumerate(msgs):
                out += (f"{role}: {self._text(message)}{seps[i % 2]}"
                        if message else f"{role}:")
            return out
        if style == SeparatorStyle.MPT:
            out = self.system + self.sep
            for role, message in msgs:
                out += (role + self._text(message) + self.sep
                        if message else role)
            return out
        if style == SeparatorStyle.LLAMA_2:
            out = ""
            for i, (role, message) in enumerate(msgs):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], \
                        "first message should come from user"
                if not message:
                    continue
                text = self._text(message)
                if i == 0:
                    text = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" + text
                if i % 2 == 0:
                    out += f"{self.sep}[INST] {text} [/INST]"
                else:
                    out += f" {text} {self.sep2}"
            return out.lstrip(self.sep)
        if style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2 or "")
            out = self.system
            for i, (role, message) in enumerate(msgs):
                if message:
                    out += self._text(message) + seps[i % 2]
            return out
        raise ValueError(f"Invalid style: {style}")

    def append_message(self, role, message):
        self.messages.append([role, message])

    def copy(self):
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset, sep_style=self.sep_style, sep=self.sep,
            sep2=self.sep2, version=self.version)

    def dict(self):
        return {"system": self.system, "roles": self.roles,
                "messages": self.messages, "offset": self.offset,
                "sep": self.sep, "sep2": self.sep2}


def _conv(system, roles, sep_style, sep, sep2=None, version="Unknown"):
    return Conversation(system=system, roles=roles, messages=[],
                        offset=0, sep_style=sep_style, sep=sep,
                        sep2=sep2, version=version)


_V0_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite "
    "answers to the human's questions.")
_V1_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite "
    "answers to the user's questions.")
_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant is able to understand the graph content "
    "that the user provides, and assist the user with a variety of "
    "tasks using natural language."
    "The graph content will be provided with the following format: "
    "<Graph>graph content</Graph>.")

conv_vicuna_v0 = _conv(_V0_SYSTEM, ("Human", "Assistant"),
                       SeparatorStyle.SINGLE, "###")
conv_vicuna_v1 = _conv(_V1_SYSTEM, ("USER", "ASSISTANT"),
                       SeparatorStyle.TWO, " ", "</s>", version="v1")
conv_llama_2 = _conv(
    "You are a helpful, respectful and honest assistant. Always answer "
    "as helpfully as possible, while being safe.  Your answers should "
    "not include any harmful, unethical, racist, sexist, toxic, "
    "dangerous, or illegal content. Please ensure that your responses "
    "are socially unbiased and positive in nature.\n\nIf a question "
    "does not make any sense, or is not factually coherent, explain "
    "why instead of answering something not correct. If you don't "
    "know the answer to a question, please don't share false "
    "information.",
    ("USER", "ASSISTANT"), SeparatorStyle.LLAMA_2, "<s>", "</s>",
    version="llama_v2")
conv_llava_llama_2 = _conv(
    "You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user "
    "provides, and assist the user with a variety of tasks using "
    "natural language.",
    ("USER", "ASSISTANT"), SeparatorStyle.LLAMA_2, "<s>", "</s>",
    version="llama_v2")
conv_llaga_llama_2 = _conv(
    "You are a helpful language and graph assistant. "
    "You are able to understand the graph content that the user "
    "provides, and assist the user with a variety of tasks using "
    "natural language.",
    ("USER", "ASSISTANT"), SeparatorStyle.LLAMA_2, "<s>", "</s>",
    version="llama_v2")
conv_mpt = _conv(
    "<|im_start|>system\nA conversation between a user and an LLM-based "
    "AI assistant. The assistant gives helpful and honest answers.",
    ("<|im_start|>user\n", "<|im_start|>assistant\n"),
    SeparatorStyle.MPT, "<|im_end|>", version="mpt")
conv_llava_plain = _conv("", ("", ""), SeparatorStyle.PLAIN, "</s>")
conv_llava_v0 = _conv(_V0_SYSTEM, ("Human", "Assistant"),
                      SeparatorStyle.SINGLE, "###")
conv_llava_v0_mmtag = _conv(_MMTAG_SYSTEM, ("Human", "Assistant"),
                            SeparatorStyle.SINGLE, "###",
                            version="v0_mmtag")
conv_llava_v1 = _conv(_V0_SYSTEM, ("USER", "ASSISTANT"),
                      SeparatorStyle.TWO, " ", "</s>", version="v1")
conv_llava_v1_mmtag = _conv(_MMTAG_SYSTEM, ("USER", "ASSISTANT"),
                            SeparatorStyle.TWO, " ", "</s>",
                            version="v1_mmtag")
conv_graphchat_v1 = _conv(
    "You are GraphGPT, a large language and graph-structral assistant "
    "trained by HKUDS Lab."
    "You are able to understand the graph structures that the user "
    "provides, and assist the user with a variety of tasks using "
    "natural language."
    "Follow the instructions carefully and explain your answers in "
    "detail.",
    ("USER", "ASSISTANT"), SeparatorStyle.TWO, " ", "</s>", version="v1")

default_conversation = conv_vicuna_v0
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "llaga_llama_2": conv_llaga_llama_2,
    "graphchat_v1": conv_graphchat_v1,
    "mpt": conv_mpt,
}


def get_conv_template(name):
    return conv_templates[name].copy()
