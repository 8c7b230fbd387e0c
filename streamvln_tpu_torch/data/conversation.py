"""Conversation templates: the `Conversation` dataclass, `SeparatorStyle`
and the registry of templates (the reference stack's llava/conversation.py
surface; the one StreamVLN exercises is `qwen_1_5` ChatML).

Own copy of `streamvln_tpu/data/conversation.py`: string-level rendering for
serving and evaluation interop; the tokenizer-level ChatML path lives in
data/chatml.py.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = "SINGLE"      # 'role: msg###' (llava v0 / vicuna v0)
    TWO = "TWO"            # vicuna: ' ' / '</s>'
    PLAIN = "PLAIN"        # bare, sep-joined
    CHATML = "CHATML"      # <|im_start|>role\n...<|im_end|>
    LLAMA_2 = "LLAMA_2"    # [INST] ... [/INST]
    LLAMA_3 = "LLAMA_3"    # <|start_header_id|>role<|end_header_id|>
    MPT = "MPT"            # role-prefix + msg + sep (role holds markup)
    GEMMA = "GEMMA"        # <start_of_turn>role\n msg <end_of_turn>


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    sep_style: SeparatorStyle
    sep: str = "\n"
    sep2: Optional[str] = None
    version: str = "unknown"

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        msgs = self.messages
        if self.sep_style == SeparatorStyle.CHATML:
            out = ""
            if self.system:
                out += f"<|im_start|>system\n{self.system}<|im_end|>\n"
            for role, msg in msgs:
                if msg is None:
                    out += f"<|im_start|>{role}\n"
                else:
                    out += (f"<|im_start|>{role}\n{msg}<|im_end|>\n")
            return out
        if self.sep_style == SeparatorStyle.MPT:
            # role strings carry their own markup (e.g.
            # '<|im_start|>user\n', '<|user|>\n') — reference
            # llava/conversation.py MPT branch
            out = self.system + self.sep if self.system else ""
            for role, msg in msgs:
                out += role
                if msg is not None:
                    out += f"{msg}{self.sep}"
            return out
        if self.sep_style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, msg in msgs:
                if msg is None:
                    out += f"{role}:"
                else:
                    out += f"{role}: {msg}{self.sep}"
            return out
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2 or self.sep]
            out = self.system + seps[0] if self.system else ""
            for i, (role, msg) in enumerate(msgs):
                if msg is None:
                    out += f"{role}:"
                else:
                    out += f"{role}: {msg}{seps[i % 2]}"
            return out
        if self.sep_style == SeparatorStyle.LLAMA_2:
            out = ""
            open_tok = self.sep if self.sep is not None else "<s>"
            close_tok = self.sep2 or "</s>"
            sys_txt = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" \
                if self.system else ""
            for i, (role, msg) in enumerate(msgs):
                if i % 2 == 0:
                    body = (sys_txt if i == 0 else "") + (msg or "")
                    out += f"{open_tok}[INST] {body} [/INST]"
                elif msg is not None:
                    out += f" {msg} {close_tok}"
            return out
        if self.sep_style == SeparatorStyle.LLAMA_3:
            eot = self.sep or "<|eot_id|>"
            out = "<|begin_of_text|>"
            if self.system:
                out += ("<|start_header_id|>system<|end_header_id|>\n\n"
                        f"{self.system}{eot}")
            for role, msg in msgs:
                out += f"<|start_header_id|>{role}<|end_header_id|>\n\n"
                if msg is not None:
                    out += f"{msg}{eot}"
            return out
        if self.sep_style == SeparatorStyle.GEMMA:
            out = ""
            for role, msg in msgs:
                out += f"<start_of_turn>{role}\n"
                if msg is not None:
                    out += f"{msg}<end_of_turn>\n"
            return out
        if self.sep_style == SeparatorStyle.PLAIN:
            return self.sep.join(m for _, m in msgs if m is not None) \
                + self.sep
        raise ValueError(self.sep_style)

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles,
                            [list(m) for m in self.messages],
                            self.sep_style, self.sep, self.sep2,
                            self.version)


def _conv(system, roles, style, sep="\n", sep2=None, version="unknown"):
    return Conversation(system=system, roles=roles, messages=[],
                        sep_style=style, sep=sep, sep2=sep2,
                        version=version)


_VICUNA_SYS_HUMAN = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite "
    "answers to the human's questions.")
_VICUNA_SYS_USER = (
    "A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite "
    "answers to the user's questions.")
_LLAVA_SYS = (
    "You are a helpful language and vision assistant. You are able to "
    "understand the visual content that the user provides, and assist "
    "the user with a variety of tasks using natural language.")
_MMTAG_SYS = (
    "Answer the questions about the visual content that the user "
    "provides.The visual content will be provided with the following "
    "format: <Image>visual content</Image>.")

# full registry breadth (reference llava/conversation.py:566-593)
_vicuna_v0 = _conv(_VICUNA_SYS_HUMAN, ("Human", "Assistant"),
                   SeparatorStyle.SINGLE, sep="###", version="v0")
_vicuna_v1 = _conv(_VICUNA_SYS_USER, ("USER", "ASSISTANT"),
                   SeparatorStyle.TWO, sep=" ", sep2="</s>",
                   version="v1")
_llama_2 = _conv(
    "You are a helpful, respectful and honest assistant.",
    ("USER", "ASSISTANT"), SeparatorStyle.LLAMA_2, sep="<s>",
    sep2="</s>", version="llama_v2")
_llava_llama_2 = _conv(_LLAVA_SYS, ("USER", "ASSISTANT"),
                       SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>",
                       version="llama_v2")
_llava_llama_3 = _conv(_LLAVA_SYS, ("user", "assistant"),
                       SeparatorStyle.LLAMA_3, sep="<|eot_id|>",
                       version="llama_v3")
_mistral_instruct = _conv("", ("USER", "ASSISTANT"),
                          SeparatorStyle.LLAMA_2, sep="", sep2="</s>",
                          version="llama_v2")
_llava_llama_2_simple = _conv(
    "Answer the questions about the visual content that the user "
    "provides.", ("USER", "ASSISTANT"), SeparatorStyle.LLAMA_2,
    sep="<s>", sep2="</s>", version="llama_v2")
_llava_llama_2_mmtag = _conv(_MMTAG_SYS, ("USER", "ASSISTANT"),
                             SeparatorStyle.LLAMA_2, sep="<s>",
                             sep2="</s>", version="llama_v2_mmtag")
_mpt = _conv(
    "<|im_start|>system\nA conversation between a user and an "
    "LLM-based AI assistant. The assistant gives helpful and honest "
    "answers.",
    ("<|im_start|>user\n", "<|im_start|>assistant\n"),
    SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")
_qwen = _conv("You are a helpful assistant.", ("user", "assistant"),
              SeparatorStyle.CHATML, version="qwen")
_qwen_2_5 = _conv(
    "You are Qwen, created by Alibaba Cloud. You are a helpful "
    "assistant.", ("user", "assistant"), SeparatorStyle.CHATML,
    version="qwen")
_gemma = _conv("", ("user", "model"), SeparatorStyle.GEMMA,
               version="gemma")
_plain = _conv("", ("", ""), SeparatorStyle.PLAIN, sep="\n")
_llava_v0 = _conv(_VICUNA_SYS_HUMAN, ("Human", "Assistant"),
                  SeparatorStyle.SINGLE, sep="###")
_llava_v0_mmtag = _conv(
    _VICUNA_SYS_USER + " The visual content will be provided with the "
    "following format: <Image>visual content</Image>.",
    ("Human", "Assistant"), SeparatorStyle.SINGLE, sep="###",
    version="v0_mmtag")
_llava_v1 = _conv(_VICUNA_SYS_HUMAN, ("USER", "ASSISTANT"),
                  SeparatorStyle.TWO, sep=" ", sep2="</s>",
                  version="v1")
_llava_v1_mmtag = _conv(
    _VICUNA_SYS_USER + " The visual content will be provided with the "
    "following format: <Image>visual content</Image>.",
    ("USER", "ASSISTANT"), SeparatorStyle.TWO, sep=" ", sep2="</s>",
    version="v1_mmtag")
_mistral_orca = _conv(
    "<|im_start|>system\nYou are MistralOrca, a large language model "
    "trained by Alignment Lab AI. Write out your reasoning "
    "step-by-step to be sure you get the right answers!",
    ("<|im_start|>user\n", "<|im_start|>assistant\n"),
    SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")
_mistral_zephyr = _conv(
    "<|system|>\nYou are a helpful AI assistant.",
    ("<|user|>\n", "<|assistant|>\n"), SeparatorStyle.MPT,
    sep="</s>", version="mpt")
_mistral_direct = _conv(
    "<|im_start|>system\nAnswer the questions.",
    ("<|im_start|>user\n", "<|im_start|>assistant\n"),
    SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")
_chatml_direct = _conv(
    "<|im_start|>system\nAnswer the questions.",
    ("<|im_start|>user\n", "<|im_start|>assistant\n"),
    SeparatorStyle.MPT, sep="<|im_end|>", version="mpt")

conv_templates = {
    "default": _vicuna_v0,
    "v0": _vicuna_v0,
    "v1": _vicuna_v1,
    "vicuna_v1": _vicuna_v1,
    "llama_2": _llama_2,
    "mistral_instruct": _mistral_instruct,
    "mistral_orca": _mistral_orca,
    "mistral_zephyr": _mistral_zephyr,
    "mistral_direct": _mistral_direct,
    "plain": _plain,
    "v0_plain": _plain,
    "chatml_direct": _chatml_direct,
    "llava_v0": _llava_v0,
    "llava_v0_mmtag": _llava_v0_mmtag,
    "llava_v1": _llava_v1,
    "llava_v1_mmtag": _llava_v1_mmtag,
    "llava_llama_2": _llava_llama_2,
    "llava_llama_3": _llava_llama_3,
    "llava_llama_2_simple": _llava_llama_2_simple,
    "llava_llama_2_mmtag": _llava_llama_2_mmtag,
    "llava_mistral_instruct": _mistral_instruct,
    "mpt": _mpt,
    "qwen_1_5": _qwen,
    "qwen_2": _qwen,
    "qwen_2_5": _qwen_2_5,
    "gemma_instruct": _gemma,
}
default_conversation = conv_templates["qwen_1_5"]
