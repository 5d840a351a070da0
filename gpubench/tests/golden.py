"""Pinned readings of the dots.ocr architecture: ``arch/dotsocr.py`` and the
shared yardstick must give them again, bit for bit (the hashes) and exactly
(the gaps and the counts), so that how the harness finds an architecture
moves no number of a cell.

Tiny: ``data/configs/tiny.json``. Hashes: sha256 of each leaf's bytes of
``make_weights(tiny, seed, "cpu", torch.float32, tiny["weights"])``. Gaps:
``served_gaps`` over ``make_weights(tiny, 7, "cpu", torch.bfloat16, ...)``,
the page ``PAGE``, the prompt ``PROMPT`` and the tokens ``SERVED``.
Flagship: ``configs/dotsocr-w8a16.json``.
"""

PROMPT = "Read the page."
PAGE = (0, (56, 84, 3))  # numpy default_rng(seed) integers in [0, 256), shape
SERVED = [5, 17, 300, 42, 511, 7, 100, 200, 3, 9]
PROMPT_LEN = 41  # prompt_ids(PROMPT, 6 vision tokens)

LEAF_SHA256 = {
    7: {
        "vision/patch_embed/kernel":
            "17e404679d597f8fff2c704b6827e6aee7c349b64ab480b5855161535244ea2c",
        "vision/patch_embed/bias":
            "0aae7723e70982e30c8b2bb372833d3a46ec4eb559e212576e46a943d8836e53",
        "vision/blocks/norm1":
            "f71aee0e8c2c913d6f78c19837166bfbd2378606e8690f8c3ce1ab7d44bfaa7e",
        "vision/blocks/norm2":
            "4c0efa8e7de11dbd7d61f44aa3cbc76e8def9e90879121906b68e9136c1a35ea",
        "vision/blocks/attn/wq":
            "7d18c977995025ad527ac9b9b13454dffab723637ffa89f33949bcc8f26a3b78",
        "vision/blocks/attn/wk":
            "68ea7edeed03ccb4c4caf5980bcba634678fd0493a14cea92324336e28cc58de",
        "vision/blocks/attn/wv":
            "f8e9ae2dace6b52428a0a0a99841151a661cc1f7b92bfeecc8bc66aa9c2ca562",
        "vision/blocks/attn/wo":
            "d53756e8f1a4447f30026779cf0bab80da264fcb02de164e9976bac9980723c4",
        "vision/blocks/attn/bq":
            "ee0e457b7e99be857bb6216c8fcd9c9ba584acc42d25929183976cdef3b0cbab",
        "vision/blocks/attn/bk":
            "a965cbdc962c7cd657dc2d07281ffc04683183c8b34cd00dc233bcae057c3115",
        "vision/blocks/attn/bv":
            "75267cfdba80ebc47c608a5f858fda0560e69ca132a98add41df68915e1be08c",
        "vision/blocks/mlp/gate":
            "fd2518a860d56fd36efc668737395dd6e36be957a8d4cd2655392c270389a3c5",
        "vision/blocks/mlp/up":
            "1d0f167deb566890bda00965c92f773c75d7ad5ef09d0a12de243b36830bbec9",
        "vision/blocks/mlp/down":
            "ed558f5d4fea77c854aecbc7ed0119e33ad80f2caa4bdc87b7d06f6ef49f84f7",
        "vision/post_norm":
            "7c2491875d642261d476514d0b9463d61b199222bbb79c6ab8bfaf1548d8024f",
        "vision/merger/norm":
            "0340a4c80f10e972081216d44d882c13e3d379adf109e61ca4f1ea6489bc5ad0",
        "vision/merger/fc1":
            "7d669690474a3eaf2469f13a2bd684831f95ab0fd22a7c42129ab4239611b423",
        "vision/merger/b1":
            "d05801fef2e9e587b64e649bae663be50e9e6fc122b395f6642d8436218140b4",
        "vision/merger/fc2":
            "cf864bcebb5fe12db1e3cd241c818f3a96a81c71bfa407fdfd1806a965322195",
        "vision/merger/b2":
            "028a3f2c3670b4ebbfab820b7879052dffde88bf5edadee1eb8af334d97f4531",
        "decoder/embed":
            "44f51e05f85977dc49cf4f80492fde41e73065c6a5646f868235f05b1e007b98",
        "decoder/blocks/input_norm":
            "29af3ef2b38ebb80a11b559b11f0f9b56a364674331c573c2692d98d7823ee2e",
        "decoder/blocks/post_attn_norm":
            "bad463d8e7d7ce3f9d7a901d61cf80424d063733ed83ff51e793f7f66da4c0ae",
        "decoder/blocks/attn/wq":
            "e41a62afbc91a35f7d27da5f3e445af40fb851cd4e01a09a0bb4c8be82d95221",
        "decoder/blocks/attn/wk":
            "b1d49e3212d05174d443808df934cd3d58a5f4bfbf896d691f6941660288e9b7",
        "decoder/blocks/attn/wv":
            "f47103ee749d720d48fbfcf2fed28fc3ac7952553f34bbb06d91b1969ba80c15",
        "decoder/blocks/attn/wo":
            "fe546a181edbabc4670eb006f7b77ff629019cc08699655a24679443fd2cfa6a",
        "decoder/blocks/attn/bq":
            "11ab09faf6c543d6c25d3c01dac56b7986db50b715409a4c95f647dfdbeae2ae",
        "decoder/blocks/attn/bk":
            "626504e7e1211391e3cb11d9d80c84c4f78b598d86643ffd3f800c764871f55f",
        "decoder/blocks/attn/bv":
            "3024bf2f6bd1e3951aa83b903ce1e065d4c25c1e89405ef911ec236ea21fdf67",
        "decoder/blocks/mlp/gate":
            "8cc86cb2a9283b82e93028f4acb0f955238bfaf6cc740f6b791ba55ba18a4aa3",
        "decoder/blocks/mlp/up":
            "5123c751956c3cb4888afb162fd962cdcc9b67206862ee9c5681c07712f8c65d",
        "decoder/blocks/mlp/down":
            "87fb3012b9c598eca3b97c2a2975e189fbe039c36cbd581da01b30e720173baf",
        "decoder/final_norm":
            "fb0b58dd4bb9cc916b7bee1b8d2c31491544eed316f412c6eb4369f91ab710ec",
    },
    2630164819342728574: {
        "vision/patch_embed/kernel":
            "a2313b8577d6e29bec1534fe23741327306d2f6964f0f0b9bf5de24ffce1e492",
        "vision/patch_embed/bias":
            "c0c56d9e4570f3801e0896073d82f7772b36eff76c16a63e05f899802079f581",
        "vision/blocks/norm1":
            "febd7fb63e37d76eea1f6eb011beece75b4c99b3132baf23c89f85ac118d6228",
        "vision/blocks/norm2":
            "b1a01eb1cde356ea903b52c11655315daf8f67d00b35fa3524ff0d23f03e57b2",
        "vision/blocks/attn/wq":
            "c9606079565ee3916cbd084d81b9a9c5db1b10b37a6d8600cb841cd578109626",
        "vision/blocks/attn/wk":
            "e5f6060ebef4664c2681672ff30b83c653508365984be812e9130f3336da6a21",
        "vision/blocks/attn/wv":
            "47409d2e7a0af19408a48ab4c87e8ae31b4b239c18213aabb4507dddb1e28812",
        "vision/blocks/attn/wo":
            "e63cc466667896eb4a0e70e13fadf00f6fa2f642e83025992451fc3344293d0e",
        "vision/blocks/attn/bq":
            "cda674d3d8961f7de9f51219ecdd4ec497a6eb7c568e1f71c9f3dd284f196a6f",
        "vision/blocks/attn/bk":
            "ad6a736fdc63fbcc162100a8a0358a2456052ec7530f0569aa938c4d2a31c632",
        "vision/blocks/attn/bv":
            "e243fb4a90a4ef75435291c51308a27680b540ef61b20703decd067946801710",
        "vision/blocks/mlp/gate":
            "6f25a0fab3c03e51258c27af01df20abf3ec28f5147635d0a383b682750430a2",
        "vision/blocks/mlp/up":
            "ca271d3b539af5296900633d52559e74eb82e84452416a75e06a3c280115c056",
        "vision/blocks/mlp/down":
            "ff8d0cf4bb94adde521e8f2f77828095a1c5a4b2d7c1ca47a02fcc615301ca44",
        "vision/post_norm":
            "f3039402971ad555407e841fd19e7817246fbf20e46c445b3aa97cbfbaff0c34",
        "vision/merger/norm":
            "2a5232a9f9bcb8d62ae015a7362315e101fa0cb990d23cb826842cc3e6f7dcbb",
        "vision/merger/fc1":
            "81fb924218220311239149868c39813d79f831b1bccb77c3d23959842e2271dc",
        "vision/merger/b1":
            "f2e86ff6691fab28fe5e8e20fc8676240fa3c48fe79ae02f3d3352e07cff1476",
        "vision/merger/fc2":
            "ca098d3d52e8e338981f0014eeb6c0454144699fad26127faae4a2d5f8298b0c",
        "vision/merger/b2":
            "0b9a98a407fdb7cef794feffb1e4954527ef0a83142175cff69f42c9ccc228d8",
        "decoder/embed":
            "b1a50b71da9669a570a5159e2323c0009713d9bccd7c705986475dd176cf3e51",
        "decoder/blocks/input_norm":
            "4c864b0a835cdf37743e845dfbdf82e670d2c3405a81beb27ad6fb27db1659bb",
        "decoder/blocks/post_attn_norm":
            "b9a44af0d65fc670c8e11ae556ed3c3a69b725f8e86f376709a954d85c4d54f7",
        "decoder/blocks/attn/wq":
            "c51d475761001ff70688291c5c04b3e53b9cb025c924fe74809f6ec7f3828409",
        "decoder/blocks/attn/wk":
            "b3295085581dc08c6139d3f0f50dc6d7d3d444144e1b78e1937da7dad00dd143",
        "decoder/blocks/attn/wv":
            "b6335c0d9fb88fc0e4b33d2ddd00095d851ae6b9a760350df731bb7df379b296",
        "decoder/blocks/attn/wo":
            "fd75517b0930110208c49f76492e1281454556e314b1c399e1ed48cf509437eb",
        "decoder/blocks/attn/bq":
            "1443eace73447918f4a2081be951caf16f091dc616fe90761611d0ac1c8ca7e7",
        "decoder/blocks/attn/bk":
            "6c896ab87d025eb6de5b4e574ce95b9e65b4d0258265186aa8ebe5a8b061db8e",
        "decoder/blocks/attn/bv":
            "a1f7520439355c2d709233ce92c55b4906f7c14c728aeb3561d14d9f4bdaf30b",
        "decoder/blocks/mlp/gate":
            "2af8a6c545963371c8f7fbfb3baf18b37f03d45e119a721c57fb7ba91737dd36",
        "decoder/blocks/mlp/up":
            "f4d57e53e41e4ada1cb9f5b24f419b58d09554c24ecb39885751331592c5f4a6",
        "decoder/blocks/mlp/down":
            "d6cfadc91909167c13ec5d604a40863bf16d289534adc297b3a1815d3d742d2a",
        "decoder/final_norm":
            "1248dd9e40d93061aa32a5d519c95b2d778abca7836f1531a12c86d45cf2a3e6",
    },
}

GAPS = {
    "none": [
        11.291200637817383, 7.989455223083496, 9.252021789550781, 11.06545352935791,
        9.464765548706055, 14.564745903015137, 5.66986083984375, 9.656801223754883,
        14.409244537353516, 10.311701774597168,
    ],
    "int8": [
        11.202966690063477, 8.006794929504395, 9.298016548156738, 10.859594345092773,
        9.441854476928711, 14.62508487701416, 5.699619293212891, 9.56352710723877,
        14.344406127929688, 10.515010833740234,
    ],
}

VISION_FLOPS = {1380: 3876725145600.0, 5040: 18918531072000.0}
PROMPT_FLOPS = {1: 3087310848.0, 1500: 4124718907392.0}
GENERATED_FLOPS = {(2, 201): 6208856064.0, (300.5, 123456.25): 948923639808.0}
KV_BYTES_PER_TOKEN = {"bf16": 28672, "int8": 14784}
PAGE_BYTES = 3670016  # w8a16.snap-ocr: 128 tokens of bf16 K and V
W8A16_PREFILL_BOUND = {1500: (3930587136000.0, 4774920192.0)}
W8A16_DECODE_BOUND = {12.5: (38589235200.0, 1546757632.0)}
