"""A cell cut to a size a CPU test holds: two layers, 16 query heads, three
requests of 20..80 rows over pages of 16, at the published widths."""

from perfbench import harness


def tiny_spec(cell: str, **mix) -> dict:
    spec = harness.cell_spec(cell)
    spec["config"] = dict(spec["config"], num_hidden_layers=2, num_attention_heads=16)
    lengths = dict(spec["mix"]["lengths"], median=40, sigma=0.5, min=20, max=80, total=150)
    spec["mix"] = dict(spec["mix"], batch=3, page_size=16, lengths=lengths, **mix)
    return spec
