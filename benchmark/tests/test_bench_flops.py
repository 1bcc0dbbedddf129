"""The operation and byte counters against counts by hand at tiny sizes."""
from benchmark.flops import attention, model
from benchmark.tests import tiny


def test_attention_launches_by_hand():
    unet = tiny.CONFIG["model"]["params"]["unet_config"]["params"]
    # 2 clips of 4 frames at 16 x 16 latents; levels ds 1 (32 ch, 2 heads of
    # 16) and ds 2 (64 ch, 4 heads); one res block a level
    calls = attention.launches(unet, n=2, t=4, h=16, w=16)
    # init_attn (8 heads of 16 over T at 256 positions), then spatial +
    # temporal at: input ds1, input ds2, middle ds2, output ds2 x2, output ds1 x2
    assert len(calls) == 2 + 7 * (3 + 2)
    init = calls[0]
    assert init["kernel"] == "K2"
    assert init["flops"] == 4 * 2 * 256 * 8 * 4 * 4 * 16
    assert init["bytes"] == 2 * 4 * 2 * 4 * 256 * 8 * 16
    self_ds1 = calls[2]
    assert self_ds1["kernel"] == "plain"          # 256 tokens < 2048
    assert self_ds1["flops"] == 4 * 8 * 2 * 256 * 256 * 16
    assert self_ds1["bytes"] == 2 * 8 * 2 * 16 * 4 * 256
    assert attention.count(calls) == {"K2": 16, "plain": 21}


def test_a_shallow_call_has_the_top_level_alone():
    unet = tiny.CONFIG["model"]["params"]["unet_config"]["params"]
    calls = attention.launches(unet, n=2, t=4, h=16, w=16, shallow=True)
    # init_attn, then spatial + temporal at input ds1 and output ds1 x2
    assert attention.count(calls) == {"K2": 2 + 3 * 2, "plain": 3 * 3}
    p = model.parts(tiny.CONFIG, frames=4, height=32, width=32)
    assert 0 < p["unet_shallow"] < p["unet"]


def test_flash_routing_at_the_shipped_512_shape():
    import json
    from benchmark import harness
    cfg = json.loads((harness.BENCH / "configs" / "dynamicrafter_512.json").read_text())
    unet = cfg["model"]["params"]["unet_config"]["params"]
    calls = attention.launches(unet, n=2, t=16, h=40, w=64)
    c = attention.count(calls)
    assert (c["K1"], c["K2"]) == (5, 34)
    k1 = [x for x in calls if x["kernel"] == "K1"][0]
    assert k1["flops"] == 4 * 32 * 5 * 2560 * 2560 * 64
    assert k1["bytes"] == 2 * 32 * 5 * 64 * 4 * 2560


def test_text_tower_operations_by_hand():
    p = model.parts(tiny.CONFIG, frames=4, height=32, width=32)
    w, n, layers = 48, 77, 1        # two layers, the last dropped (penultimate)
    per_layer = (2 * n * w * 3 * w + 2 * 2 * n * n * w + 2 * n * w * w
                 + 2 * 2 * n * w * 4 * w)
    assert p["text"] == layers * per_layer


def test_decode_is_counted_untiled():
    p = model.parts(tiny.CONFIG, frames=4, height=32, width=32)
    assert p["decode"] > 0 and p["unet"] > 0
    assert model.clip_flops(p, 4, 6) == 2 * p["text"] + 2 * p["image"] + 4 * (
        p["encode"] + p["decode"]) + 6 * p["unet"]
