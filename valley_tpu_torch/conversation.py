"""Conversation state and prompt templates.

The PyTorch port's own copy of ``valley_tpu/conversation.py`` (numpy only, no
jax), so that the port imports nothing of the JAX package.

Behavioral parity with the reference's `valley/conversation.py`:
the "###"-separated SINGLE style (`get_prompt`, `conversation.py:25-35`),
the TWO style (`:36-46`), the registered templates `v1` /
`multimodal_video` (`:200-228`) and the media helpers used by the serve
layer.  Implemented fresh; images are handled as PIL objects only where the
serve layer needs them (lazy imports keep the core dependency-free).
"""

from __future__ import annotations

import base64
import dataclasses
import enum
from io import BytesIO
from typing import Any, List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()


@dataclasses.dataclass
class Conversation:
    """Mutable multi-turn conversation history.

    ``messages`` entries are ``[role, message]`` where message is either a
    string or a tuple ``(text, media, image_process_mode)`` for turns that
    carry an uploaded image/video (reference `conversation.py:54-116`).
    """

    system: str
    roles: Tuple[str, str]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    mode: Optional[str] = None
    skip_next: bool = False

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.SINGLE:
            out = [self.system + self.sep]
            for role, message in self.messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    out.append(f"{role}: {message}{self.sep}")
                else:
                    out.append(f"{role}:")
            return "".join(out)
        if self.sep_style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            out = [self.system + seps[0]]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    out.append(f"{role}: {message}{seps[i % 2]}")
                else:
                    out.append(f"{role}:")
            return "".join(out)
        raise ValueError(f"Invalid separator style: {self.sep_style}")

    def append_message(self, role: str, message: Any) -> None:
        self.messages.append([role, message])

    # ---- media extraction (serve layer) --------------------------------

    def get_video(self):
        """b64-encode every video attached to a human turn
        (reference `conversation.py:54-65`)."""
        videos, paths = [], []
        for i, (_role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0 and isinstance(msg, tuple):
                _text, video_path, _mode = msg
                paths.append(video_path)
                with open(video_path, "rb") as f:
                    videos.append(base64.b64encode(f.read()))
        return videos, paths

    def get_images(self, return_pil: bool = False):
        """Extract, aspect-resize, and (optionally) b64-JPEG every image
        attached to a human turn (reference `conversation.py:66-116`)."""
        from PIL import Image  # lazy; serve-only dependency

        images = []
        for i, (_role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 != 0 or not isinstance(msg, tuple):
                continue
            _text, image_list, mode = msg
            if not isinstance(image_list, list):
                image_list = [image_list]
            for image in image_list:
                if mode == "Pad":
                    image = _expand2square(image)
                elif mode == "Resize":
                    image = image.resize((224, 224))
                elif mode != "Crop":
                    raise ValueError(f"Invalid image_process_mode: {mode}")
                image = _aspect_resize(image)
                if return_pil:
                    images.append(image)
                else:
                    buf = BytesIO()
                    image.save(buf, format="JPEG")
                    images.append(base64.b64encode(buf.getvalue()).decode())
        return images

    def to_gradio_chatbot(self):
        ret = []
        for i, (_role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0:
                if isinstance(msg, tuple):
                    text, image, _mode = msg
                    image = _aspect_resize(image)
                    buf = BytesIO()
                    image.save(buf, format="JPEG")
                    b64 = base64.b64encode(buf.getvalue()).decode()
                    html = (f'<img src="data:image/png;base64,{b64}" '
                            'alt="user upload image" />')
                    ret.append([text.replace("<image>", "") + html, None])
                else:
                    ret.append([msg, None])
            else:
                ret[-1][-1] = msg
        return ret

    def video_to_gradio_chatbot(self):
        ret = []
        for i, (_role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0:
                if isinstance(msg, tuple):
                    text, video, _mode = msg
                    with open(video, "rb") as f:
                        b64 = base64.b64encode(f.read()).decode("utf-8")
                    html = (
                        f'<video controls align="left" style="height: 200px;"'
                        f' src="data:video/mp4;base64,{b64}">'
                        "Your browser does not support the video tag."
                        "</video>")
                    ret.append([text.replace("<video>", "") + html, None])
                else:
                    ret.append([msg, None])
            else:
                ret[-1][-1] = msg
        return ret

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2)

    def dict(self):
        return {
            "system": self.system,
            "roles": list(self.roles),
            "messages": [[r, m[0] if isinstance(m, tuple) else m]
                         for r, m in self.messages],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


def _expand2square(pil_img, background_color=(122, 116, 104)):
    from PIL import Image

    width, height = pil_img.size
    if width == height:
        return pil_img
    side = max(width, height)
    result = Image.new(pil_img.mode, (side, side), background_color)
    if width > height:
        result.paste(pil_img, (0, (width - height) // 2))
    else:
        result.paste(pil_img, ((height - width) // 2, 0))
    return result


def _aspect_resize(image, max_len: int = 800, min_len: int = 400):
    """Bound the short edge to min(800/aspect, 400, short_edge) while keeping
    the aspect ratio (reference `conversation.py:98-108`)."""
    max_hw, min_hw = max(image.size), min(image.size)
    aspect_ratio = max_hw / min_hw
    shortest = int(min(max_len / aspect_ratio, min_len, min_hw))
    longest = int(shortest * aspect_ratio)
    w, h = image.size
    if h > w:
        h, w = longest, shortest
    else:
        h, w = shortest, longest
    return image.resize((w, h))


conv_v1_2 = Conversation(
    system=("A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."),
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

simple_conv_video = Conversation(
    system=("You are Valley, a large language and vision assistant trained "
            "by ByteDance."
            "You are able to understand the visual content or video that the "
            "user provides, and assist the user with a variety of tasks "
            "using natural language."
            "Follow the instructions carefully and explain your answers in "
            "detail."),
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "Hi!"],
        ["Assistant", "Hi there!  How can I help you today?\n"],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

default_conversation = simple_conv_video
conv_templates = {
    "v1": conv_v1_2,
    "multimodal_video": simple_conv_video,
}
