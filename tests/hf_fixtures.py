"""Tiny HuggingFace checkpoints and a tokenizer, built locally (no hub, no
network) for the HF import tests: seeded random weights saved with
``save_pretrained`` in the formats ``transformers`` writes."""

import numpy as np
import torch

VOCAB = 120
WORDS = ["le", "chat", "noir", "dort", "un", "contrat", "la", "loi", "de", "travail", "tribunal", "juge"]


def tokenizer_dir(path) -> str:
    """A WordLevel tokenizer over <s> <pad> </s> <unk> <mask> and ``WORDS``
    with RoBERTa's templates, saved as a ``PreTrainedTokenizerFast``."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    vocab = {w: i for i, w in enumerate(["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + WORDS)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.RobertaProcessing(("</s>", 2), ("<s>", 0))
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                                   pad_token="<pad>", cls_token="<s>", sep_token="</s>", mask_token="<mask>")
    fast.save_pretrained(str(path))
    return str(path)


def _common(**kw):
    return dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=40, **kw)


def save(model, path, **kw) -> str:
    model.save_pretrained(str(path), **kw)
    return str(path)


def roberta(seed=0):
    """A RobertaForMaskedLM with seeded weights, LayerNorm and biases moved
    off their init so that every leaf is checked."""
    from transformers import RobertaConfig, RobertaForMaskedLM

    torch.manual_seed(seed)
    model = RobertaForMaskedLM(RobertaConfig(**_common(type_vocab_size=1, pad_token_id=1, bos_token_id=0,
                                                       eos_token_id=2, layer_norm_eps=1e-5))).eval()
    _jitter(model, seed)
    return model


def bert(seed=1):
    from transformers import BertConfig, BertForMaskedLM

    torch.manual_seed(seed)
    model = BertForMaskedLM(BertConfig(**_common(type_vocab_size=2, pad_token_id=0))).eval()
    _jitter(model, seed)
    return model


def t5(seed=2, gated=False):
    from transformers import T5Config, T5ForConditionalGeneration

    torch.manual_seed(seed)
    cfg = T5Config(vocab_size=VOCAB, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4,
                   relative_attention_num_buckets=32, feed_forward_proj="gated-gelu" if gated else "relu",
                   decoder_start_token_id=0)
    model = T5ForConditionalGeneration(cfg).eval()
    _jitter(model, seed)
    return model


def _jitter(model, seed):
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "LayerNorm" in name or "layer_norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))


def token_batch(seed=0, n=3, length=11, pad=1):
    """Ragged ids over the tiny vocab (one row padded short)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, VOCAB, size=(n, length)).astype(np.int64)
    mask = np.ones_like(ids)
    ids[1, 6:], mask[1, 6:] = pad, 0
    return ids, mask


XMOD_LANGS = ["fr_XX", "en_XX", "de_DE"]


def xmod(seed=0, mlm=False):
    """A tiny X-MOD (xmod-base's flags) with three language adapters, seeded."""
    from transformers import XmodConfig, XmodForMaskedLM, XmodModel

    cfg = XmodConfig(**_common(type_vocab_size=1, pad_token_id=1, bos_token_id=0, eos_token_id=2,
                               layer_norm_eps=1e-5), languages=XMOD_LANGS, adapter_reduction_factor=2,
                     adapter_layer_norm=False, adapter_reuse_layer_norm=True, ln_before_adapter=True,
                     pre_norm=False, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    model = (XmodForMaskedLM if mlm else XmodModel)(cfg).eval()
    _jitter(model, seed)
    return model
