"""Chat-template rendering (own copy of dstack_tpu.proxy.model_tgi's
``DEFAULT_CHAT_TEMPLATE`` and ``render_chat``)."""

from typing import Optional

import jinja2
import jinja2.sandbox

# Llama-3-style default; a server can override it with --chat-template
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|start_header_id|>{{ message['role'] }}<|end_header_id|>\n\n"
    "{{ message['content'] or '' }}"
    "{% if message.get('tool_calls') %}{{ message['tool_calls'] | tojson }}"
    "{% endif %}<|eot_id|>"
    "{% endfor %}"
    "{% if add_generation_prompt %}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n"
    "{% endif %}"
)


class ChatTemplateError(Exception):
    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


def render_chat(
    messages: list,
    chat_template: Optional[str] = None,
    tools: Optional[list] = None,
) -> str:
    """Messages → prompt via a sandboxed jinja chat template (``tools``
    are exposed to the template like HF ``apply_chat_template``)."""
    env = jinja2.sandbox.ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True
    )

    def _raise(message: str):
        raise jinja2.TemplateError(message)

    env.globals["raise_exception"] = _raise
    try:
        template = env.from_string(chat_template or DEFAULT_CHAT_TEMPLATE)
        return template.render(
            messages=messages, tools=tools, add_generation_prompt=True
        )
    except jinja2.TemplateError as e:
        raise ChatTemplateError(f"chat template failed: {e}")
