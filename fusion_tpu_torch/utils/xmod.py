"""X-MOD (cross-lingual modular) adapter utilities.

The reference imports ``set_xmod_language`` / ``prepare_xmod_for_finetuning``
but never defines them (a latent break upstream).  These pin the language
adapter for inference and freeze embeddings + adapters for fine-tuning (the
X-MOD paper recipe), on an HF X-MOD torch model as in the JAX package, or
on the port's ``BiEncoder`` / ``ColBERT`` over an X-MOD trunk.

Language codes come from ``MMARCO_LANGUAGES`` (the (name, xx_XX) table the
reference keeps in splade/mmarco.py, as ``fusion_tpu/data/mmarco.py``
holds it).
"""

from __future__ import annotations

MMARCO_LANGUAGES: dict[str, tuple[str, str]] = {
    "ar": ("arabic", "ar_AR"),
    "de": ("german", "de_DE"),
    "en": ("english", "en_XX"),
    "es": ("spanish", "es_XX"),
    "fr": ("french", "fr_XX"),
    "hi": ("hindi", "hi_IN"),
    "id": ("indonesian", "id_ID"),
    "it": ("italian", "it_IT"),
    "ja": ("japanese", "ja_XX"),
    "nl": ("dutch", "nl_XX"),
    "pt": ("portuguese", "pt_XX"),
    "ru": ("russian", "ru_RU"),
    "vi": ("vietnamese", "vi_VN"),
    "zh": ("chinese", "zh_CN"),
}


def xmod_language_code(lang: str) -> str:
    """'fr' → 'fr_XX' (the X-MOD adapter naming scheme)."""
    if lang in MMARCO_LANGUAGES:
        return MMARCO_LANGUAGES[lang][1]
    if "_" in lang:
        return lang
    raise ValueError(f"unknown language {lang!r}; expected one of {sorted(MMARCO_LANGUAGES)}")


def set_xmod_language(model, lang: str):
    """Pin an X-MOD model to one language adapter for inference: the port's
    models through their ``set_language``, an HF torch model through its
    ``set_default_language``."""
    code = xmod_language_code(lang)
    if hasattr(model, "set_language"):
        return model.set_language(code)
    if hasattr(model, "set_default_language"):
        model.set_default_language(code)
        return model
    base = getattr(model, "base_model", None)
    if base is not None and hasattr(base, "set_default_language"):
        base.set_default_language(code)
        return model
    raise TypeError("model does not expose X-MOD set_default_language")


def prepare_xmod_for_finetuning(model, lang: str):
    """Freeze embeddings and language adapters, train the shared body (the
    X-MOD fine-tuning recipe: adapters stay language-specific).  For the
    port's models this marks the parameters (``requires_grad``); its
    trainer takes the same recipe as ``models.xmod.xmod_finetune_labels``."""
    set_xmod_language(model, lang)
    if hasattr(model, "freeze_embeddings_and_language_adapters"):
        model.freeze_embeddings_and_language_adapters()
        return model
    frozen = 0
    for name, param in getattr(model, "module", model).named_parameters():
        if "adapter" in name or "embeddings" in name:
            param.requires_grad = False
            frozen += 1
    if frozen == 0:
        raise TypeError("model has no X-MOD adapters/embeddings to freeze")
    return model


def detect_language(text: str, default: str = "fr") -> str:
    """Best-effort language detection (``langdetect`` where installed, else
    ``default``)."""
    try:
        from langdetect import detect

        code = detect(text)
        return code if code in MMARCO_LANGUAGES else default
    except Exception:
        return default
