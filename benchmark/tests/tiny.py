"""Small versions of the cells for the benchmark's own CPU tests: the same
files, with the widths, depth and traffic cut so a CPU run takes seconds."""

from __future__ import annotations

import copy

from benchmark.lib import registry

TINY_LM = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
           "sliding_window": 64, "max_position_embeddings": 256, "vocab_size": 134,
           # the full model's logit scale: 0.02 * sqrt(4096 / 64)
           "initializer_range": 0.16}


TINY_LIMITS = {
    # sound 0.0; a token altered 5.0
    "dialog": {"served_logit_gap": 1.0},
    # sound <= 6e-4 / 2.7e-3 / 1.2e-3; fp8 control >= 6e-4 / 1.9e-2 / 7.4e-3;
    # half the labels >= 6.6e-3 / 9.7e-2 / 0.17
    "lm_train": {"loss_rel": 2e-3, "grad_gap": 8e-3, "change_gap": 4e-3},
    # sound <= 5.3e-4 / 2.7e-3 / 5.3e-4; fp8 control >= 1.6e-3 / 1.1e-2 / 6.1e-3;
    # half the labels >= 3.6e-3 / 3.7e-2 / 5.6e-3 (median leaf)
    "lora": {"loss_rel": 2e-3, "grad_gap": 6e-3, "change_gap": 2.5e-3},
}


def cell(name: str) -> dict:
    c = copy.deepcopy(registry.find_cell(registry.load_spec(), name))
    c["config"].update(TINY_LM)
    mix = c["traffic"]
    # limits read at this size on the CPU (sound runs, faults and controls
    # on four seeds each; the cells' own limits are read at full size)
    mix["limits"] = dict(TINY_LIMITS[mix["driver"] if "lora" not in mix else "lora"])
    if mix["driver"] == "dialog":
        c["config"]["tokenizer"] = {"kind": "test", "num_units": 32}
        mix.update(conversations=4, num_units=32,
                   user_units={"dist": "lognormal", "median": 30, "sigma": 0.4, "min": 16,
                               "max": 60},
                   budgets={"unit2text": {"dist": "uniform", "min": 4, "max": 8},
                            "text2text": {"dist": "uniform", "min": 4, "max": 8},
                            "text2unit": {"dist": "uniform", "min": 8, "max": 16}},
                   engine={"max_batch_size": 4, "page_size": 16, "max_pages_per_seq": 32,
                           "decode_horizon": 4, "prefill_chunk": 32},
                   warmup={"solo_rounds": 1, "budget": 4, "lead_in_s": 0.5}, check={"requests": 4})
    else:
        mix.update(row_tokens=96, docs_per_row=3,
                   doc_lengths={"dist": "lognormal", "median": 24, "sigma": 0.9, "min": 8,
                                "max": 64})
        mix["train"]["ce_chunk"] = 32
        if "lora" in mix:
            mix["lora"]["b_std"] = 0.05
    return c
