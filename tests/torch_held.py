"""The shipped configs held last against the JAX package, and the
variants of their reduced twins that keep what ``ModelConfig.reduced()``
drops: it caps ``n_kv_heads`` at 2 (``deepseek-7b``'s MHA becomes GQA 4 /
2) and sets ``d_head`` to ``d_model / n_heads`` (``gemma3-12b``'s 256 at
3840 / 16 heads is not).  A variant is ``"<arch>:<tag>"``, made by
``replace()`` on the reduced config in both packages alike.  Imports
neither package."""
SHIPPED = ["gemma3-12b", "qwen3-8b", "deepseek-7b", "dbrx-132b"]
VARIANTS = {"deepseek-7b:mha": {"n_kv_heads": 4},
            "gemma3-12b:d_head32": {"d_head": 32}}
HELD = SHIPPED + list(VARIANTS)
DENSE = ["gemma3-12b", "qwen3-8b", "deepseek-7b"]


def reduced(get_config, name, **kw):
    """``name``'s reduced twin (``get_config(arch)``: either package's
    config of that name), with its variant's fields and then ``kw``."""
    cfg = get_config(name.split(":")[0]).reduced()
    return cfg.replace(**{**VARIANTS.get(name, {}), **kw})
