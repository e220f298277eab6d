"""The loader core's own JPEG decoder and writer (`efficientteacher_torch/
csrc/jpeg_decode.h`, `jpeg_encode.h`; no libjpeg) against cv2.imread.

Tolerance: exact everywhere. The decoder equals cv2.imread (libjpeg-turbo
with its defaults: ISLOW IDCT, fancy upsampling) bit for bit on every kind
it reads x quality {50, 75, 90, 95} x odd sizes, seeded noise blurred and
not; its 1/2, 1/4, 1/8 prescale equals cv2's IMREAD_REDUCED_COLOR_* reads;
every sampling set libjpeg decodes (`SAMPLING_SETS`, written by this
module's own baseline encoder `encode_baseline`, since cv2 writes five)
equals cv2 at every scale, and the sets libjpeg refuses raise;
the EXIF orientation is applied as cv2.imread applies it; the writer's
files decode identically in cv2 and in the core; each kind the decoder
once refused is read as cv2 reads it, or, where libjpeg refuses it too,
leaves the dataset (tests/test_torch_jpeg_damaged.py holds the damaged
and rare kinds at every scale).

`FIXTURES` are a few small files written once with cv2.imwrite (quality
75, the sampling / progressive / restart options their names give, seeded
blurred noise; orientation6 has an Exif APP1 spliced in by
`with_exif_orientation`; rgb and cmyk by Pillow 12.1.0, ycck the cmyk file
with its Adobe transform set to 2), each with the SHA-256 of cv2.imread's
RGB output
at scale 1, 1/2, 1/4, 1/8 (the reduced reads ignore the orientation, as
the prescale route does). The card's machine has no libjpeg: there the
digests are the oracle (`check_fixtures`, called by chip_smoke.py and
tests/test_torch_cuda.py). This module imports no JAX and imports cv2
and Pillow only inside the tests that compare against them.
"""

import base64
import hashlib
import struct
from pathlib import Path

import numpy as np
import pytest

from efficientteacher_torch.data import datasets as port_ds
from efficientteacher_torch.data import image_io
from efficientteacher_torch.utils import native_loader as nl

# name: (base64 file, {denom: ((h, w, 3), sha256 of the RGB bytes)})
FIXTURES = {
    "baseline_420": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wAARCAATABcDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhBy"
        "JxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqr"
        "KztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQ"
        "J3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRom"
        "JygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiI"
        "mKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwA82PJQNlT1qLY0ylOiZ4NSW9tb26"
        "F2YZ7rTWCyy7UJVW6VfMnfm+8KMVFOKf4aBbxgyMhYKijgmimXWnuwVUfoOcGim05a"
        "xloOdSlB2kvvKiktESTk1o2XMgzzxRRWUtom2b6UXYfZsxmlBOQGooorKv8AGeTWXv"
        "H/2Q==",
        {
            1: ((19, 23, 3), "394b0ac6267787371a0d1f3ba793ee61"
                "ee7fc0423d3eba430bf5058ebd8ac9c5"),
            2: ((10, 12, 3), "ea9a60de49dae93687745081724d11f3"
                "765d1e9798af56d1fb9aaa407b16fcc2"),
            4: ((5, 6, 3), "e76dcab70bea7e5260df3b0969ad9444"
                "2eacee73d466c9c63cebeddd9bdbe7a1"),
            8: ((3, 3, 3), "686b6fa91d70daff369c19a9b6e1ad10"
                "59864725b8852a252b915525db3f592e"),
        }),
    "baseline_422": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wAARCAATABcDASEAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhBy"
        "JxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqr"
        "KztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQ"
        "J3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRom"
        "JygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiI"
        "mKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwCrJNNHEEC5DHGBVhBKIhC4wnUcVV"
        "WMJQklu9UROMadVTXUvrJKiDy1wR60UqNBSheW5XLCTvLcpT2UtkQxYMAaaJDJdLhs"
        "gj8qUY3kn2HVjGSb6JD5XeZuHKbePrRVKcoLlRNJU4wSnuPd2eN9zE/L3qDTFBjckZ"
        "PNVS/gVH6FV9KdvQrOxDsMnGaK6sOk6abPPrSanZH/2Q==",
        {
            1: ((19, 23, 3), "acf1f0a7e97f1b2f30cf089d3631adc7"
                "d3a82a013b05294a3116518eedb5094c"),
            2: ((10, 12, 3), "bdd8b2a737bca2513b10c84b8a6e8ec8"
                "2034b71c97b21334c085e1d17282d231"),
            4: ((5, 6, 3), "763aa5084b60e55c9bbd415a54c20410"
                "2e2fdd5da3893d2f33d8fd89681c1d98"),
            8: ((3, 3, 3), "28f6a99e8d0a14ddbe7d4968ce44a2dd"
                "ae38f972d91ee99aa0a73b46b09c7092"),
        }),
    "baseline_444": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wAARCAATABcDAREAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhBy"
        "JxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqr"
        "KztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQ"
        "J3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRom"
        "JygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiI"
        "mKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwCVdjuEHAq61NqziWuaKbmQ3Ci2kL"
        "ZDbqiEnW0toZU725mVftCI2MlRWs4OPwo6oP3rsswLIGMbHDHuaqulfmiclTnrQUlu"
        "LJCrzbXPToa4pV5L4dC3y8tuo5o7cRDdGM+pqvaVJP3WOlTnN2iW2RTDuI+b1r0Wv3"
        "tjjqNxnaJj3zsFUhj96sowj7V6HVR1qO5euf8AkHwnua8tNrESSNMJJq9j/9k=",
        {
            1: ((19, 23, 3), "13aaaebb1d0f20f61d1f195a56536209"
                "602b12a8a1aedb65de7e1ee1a8d72593"),
            2: ((10, 12, 3), "63621ab07596e37b52423b96cdd19ccd"
                "d6405a50f25ad1c49efbe346e0f475bd"),
            4: ((5, 6, 3), "71698f5bc93b3215f469f0854894990d"
                "fa52267b2ebe3933ba0f3fed2723542a"),
            8: ((3, 3, 3), "8a0fb9364d205b932f478fab4f8710dc"
                "a127b51a8de4a045192aa322667e7829"),
        }),
    "grey": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/wAALCAATABcB"
        "AREA/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAw"
        "UFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcY"
        "GRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhI"
        "WGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ"
        "2uHi4+Tl5ufo6erx8vP09fb3+Pn6/9oACAEBAAA/AIZIorl9jD94OmT0qG+ac2gibk"
        "A4BFT6cLZoxHctsYDOTTrSI3EbIynzvpVmG1WJNs7AnqFIolgtbnBcKCvHpVyRRHew"
        "lBtJ64qMqDqZBGRisG9dkupArEDd2r//2Q==",
        {
            1: ((19, 23, 3), "a5fbb9671a0d0b0f10857e733f5c5fe6"
                "74682cfc094ca31e17a6f86e0b6162b8"),
            2: ((10, 12, 3), "48654fa621391710fc111c882ced6124"
                "c1af5a96f8126e7988f0ae37a75bd129"),
            4: ((5, 6, 3), "cd788f021199dee4c16d8066c876e539"
                "b9eb7ed0eeff73420cdc4307c92668df"),
            8: ((3, 3, 3), "5a0a8453fd265fd6822acc1b2e341d68"
                "1d29138a387974cde57cbb901526dbdf"),
        }),
    "progressive_420": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wgARCAATABcDASIAAhEBAxEB/8QAFwABAQEBAAAAAAAAAAAAAAAA"
        "AAIDAf/EABcBAQEBAQAAAAAAAAAAAAAAAAEDAgT/2gAMAwEAAhADEAAAAZ5oCVBwst"
        "jcc8v/xAAcEAACAgIDAAAAAAAAAAAAAAABAgAyAzERISL/2gAIAQEAAQUC9IbMe4X5"
        "i7YCCuO2Tf8A/8QAHBEAAQMFAAAAAAAAAAAAAAAAAAECERIhMkFR/9oACAEDAQE/AX"
        "dEbN6hcDR//8QAFxEBAQEBAAAAAAAAAAAAAAAAAQACEf/aAAgBAgEBPwHWlOtwiL//"
        "xAAYEAADAQEAAAAAAAAAAAAAAAAAESEBIP/aAAgBAQAGPwJj0pC8/wD/xAAYEAEBAQ"
        "EBAAAAAAAAAAAAAAABABExUf/aAAgBAQABPyEMKBiXEyDzJ5XqxuslOxv/2gAMAwEA"
        "AgADAAAAEFwIQf/EABcRAQEBAQAAAAAAAAAAAAAAAAEAESH/2gAIAQMBAT8QXcSE0I"
        "wXF//EABcRAQEBAQAAAAAAAAAAAAAAAAEAESH/2gAIAQIBAT8QwRmynSB2Tl//xAAb"
        "EAEAAgMBAQAAAAAAAAAAAAABABEhMUFRkf/aAAgBAQABPxAANkSY75UEa61PjhBMBv"
        "yPwKGDG4zJYFMcn//Z",
        {
            1: ((19, 23, 3), "190f03001bfabea1a6d32a00d553ec3c"
                "aef8857d0f104030bb0a1e6ef3636d86"),
            2: ((10, 12, 3), "b086df899ad6f348ffbdcd6cd9f9d463"
                "d6a0dcb99bb19c2763fb75aafb84249b"),
            4: ((5, 6, 3), "aba8b7d0881a58e66893adbe05151911"
                "099b371452a34cb7e0cf43bf67295103"),
            8: ((3, 3, 3), "787a56b35f53fd150a09a60546a1ab60"
                "275f8a18f11a952ad63739f39d2f458f"),
        }),
    "progressive_grey": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/wgALCAATABcB"
        "AREA/8QAFgABAQEAAAAAAAAAAAAAAAAAAgAD/9oACAEBAAAAAUTVju//xAAcEAACAg"
        "IDAAAAAAAAAAAAAAABAgMxACIRITL/2gAIAQEAAQUCIWTPGO2zr1Gx5kTZLWjf/8QA"
        "GhAAAgIDAAAAAAAAAAAAAAAAABABERIiYf/aAAgBAQAGPwK101MVJK//xAAaEAEAAw"
        "EBAQAAAAAAAAAAAAABABEhoTGB/9oACAEBAAE/IbIusNDWz2RRZ1EBH1gFjZuHdFzP"
        "/9oACAEBAAAAEJb/AP/EABwQAQADAQADAQAAAAAAAAAAAAEAESExQWFxwf/aAAgBAQ"
        "ABPxAnCsLgAmjqbBKnR3sSj/ifTnyY6RD7jRKpXFm0fGI1S8pP/9k=",
        {
            1: ((19, 23, 3), "9ee55ec6605e31c676894f5fbcbaaefa"
                "243b1299e91a77a73eab10921f18f191"),
            2: ((10, 12, 3), "b87de0b8dbb04cab758d8b17e2a17f1b"
                "d7c9fe6a265d365f3c6b8e1c80861895"),
            4: ((5, 6, 3), "0719daed0fa9939b5f104aba22053c72"
                "fe38989dd89239aa34e1945ac8a71d88"),
            8: ((3, 3, 3), "d56bae38d0871fe151ad31927e0e08a4"
                "f0c79ef7ab025213e6ab1a9667f7588c"),
        }),
    "restart_420": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wAARCAATABcDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhBy"
        "JxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqr"
        "KztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQ"
        "J3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRom"
        "JygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiI"
        "mKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/90ABAAB/9oADAMBAAIRAxEAPwCOaS4mchV596rfZrh5uD"
        "h6vi4LRCV8I2elQRzO915gPA9KcaknLsPnkoXl0P/Qs6bbRLua6+VqKq3F8ySgGIut"
        "FWsPWkrpJmUqkpaps//RrXXN2wPTHSkteq+7UUUVV+7k/QeI0w0LH//SfcjbPgccUU"
        "UVpQf7tHHV+Nn/2Q==",
        {
            1: ((19, 23, 3), "b10a0d899171e2f37184f49503b295f3"
                "4d95f1db0631c83bf22638644fb2d106"),
            2: ((10, 12, 3), "0cbe15accd746cc142a59e094dfef745"
                "c84785e0014fddd8751d60842f4a2b80"),
            4: ((5, 6, 3), "77fa62d508ad76ebced8e3f4b05b57ca"
                "3ecd28e27d68e1d6d4745093ee4148f6"),
            8: ((3, 3, 3), "e1ef3a0e71bbe8e648f23fe996e6d6d2"
                "423de1ece329e708320b5b0d6df26a6a"),
        }),
    "progressive_restart_422": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wgARCAATABcDASEAAhEBAxEB/8QAFgABAQEAAAAAAAAAAAAAAAAA"
        "AgAB/8QAFwEBAQEBAAAAAAAAAAAAAAAAAgABA//dAAQAAf/aAAwDAQACEAMQAAABO7"
        "f/0Nk//9FVf//SVo//0y3z/9TJ5//EABsQAAICAwEAAAAAAAAAAAAAAAABAhESITNB"
        "/9oACAEBAAEFAo2z/9A//9Gs1//STP/Tu1//1Fo//9WZ/9aPP//X9//EABsRAAICAw"
        "EAAAAAAAAAAAAAAAABAzICERIh/9oACAEDAQE/Ad+H/9BSH//RkSzR/9Lk/9N1P//U"
        "jqj/xAAaEQEBAAIDAAAAAAAAAAAAAAABAAIREiEx/9oACAECAQE/AX1v/9DaX//RUv"
        "/SceXd/9ML/9TG/8QAFhABAQEAAAAAAAAAAAAAAAAAABEB/9oACAEBAAY/Aq//0Lr/"
        "0bj/0n//04//1H//1df/1n//13//xAAZEAEBAQEBAQAAAAAAAAAAAAABABEhMUH/2g"
        "AIAQEAAT8hxN//0E5lwv/R5J//0kBMy//T+by//9THlwv/1Wz/1vK//9cOr//aAAwD"
        "AQACAAMAAAAQj//Q7//Rj//SP//TX//U/wD/xAAZEQEBAQEBAQAAAAAAAAAAAAABAB"
        "EhQcH/2gAIAQMBAT8Q5OuH2//QYMW//9EweX//0gJrf//TXV//1HrN/8QAGhEAAwEA"
        "AwAAAAAAAAAAAAAAAAERMSFBUf/aAAgBAgEBPxBU4H//0MFP/9HoZwf/0mNB/9NUan"
        "h//9R3D//EABwQAQADAAIDAAAAAAAAAAAAAAEAESExQVFhcf/aAAgBAQABPxAmC2f/"
        "0G1+6f/RuoPk/9LNOk//0w8oXXzP/9S8+lqf/9UjReJ//9bK9vLP/9ckkyf/2Q==",
        {
            1: ((19, 23, 3), "ea6612937d436dd2c3780fc8cb232ac4"
                "58a4c269de9a3c7338eecbf8d987616a"),
            2: ((10, 12, 3), "81afc024b05e71b46d645c299d1da8fd"
                "c6bbe1b295667f5a80841e9133557f0f"),
            4: ((5, 6, 3), "60ff3f9d5541d827f21b55ac8f5cd683"
                "48f4e717c3e1ccc540e1a8147d21dcc9"),
            8: ((3, 3, 3), "4c2c34dc1281785564c90e68976776ea"
                "2d7f1284744d1531836eb7d092736273"),
        }),
    "orientation6_420": (
        "/9j/4QAiRXhpZgAASUkqAAgAAAABABIBAwABAAAABgAAAAAAAAD/4AAQSkZJRgABAQ"
        "AAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4n"
        "ICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMj"
        "IyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjL/wAAR"
        "CAATABcDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8"
        "QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS"
        "0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaG"
        "lqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXG"
        "x8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQ"
        "AAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJB"
        "UQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERU"
        "ZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOk"
        "paanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+P"
        "n6/9oADAMBAAIRAxEAPwBkhRA7OpDYqGBn2NLt56Cpbe+SXImQewIpgQyNIVbavZar"
        "m197f8DRW5bX3/Afp9vH5zuTgtRUKXKWSZcHcaKiqm5XSTMeSpsKUX7aRtFTHicgdK"
        "KKqX8IlfxUVrxVaFSQDzRRRWlPY7odfU//2Q==",
        {
            1: ((23, 19, 3), "c6448332becf611f10c4ac9d9bd91d84"
                "690fbb539e3d546886856e15d10add2a"),
            2: ((10, 12, 3), "8aca1edc2d92170cb91cf9801a33fd66"
                "c07f184857e4d23fcdd2ee757502726c"),
            4: ((5, 6, 3), "354aef2b2c1db8364bf703f86679790a"
                "a115f49032abc49c41e876f00df98995"),
            8: ((3, 3, 3), "b4cb0e0b86a6530246558016c49a81d5"
                "4dcaf991f0a23eef4b60673e73fdaca7"),
        }),
    "partial_mcu_9x33_420": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wAARCAAJACEDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhBy"
        "JxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqr"
        "KztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQ"
        "J3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRom"
        "JygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiI"
        "mKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwCBna2uAIPn9qtz3bSsqFCFxz9apW"
        "v/ACEH+lTzdTSppOzfUxlZzSHRF1BjAypqaSYW+wP8rHpSW3+uWoNZ/wCPiOnh/wB/"
        "PklsjfELltNdSx9sf/noKKzKK6vqi/mOT2ku5//Z",
        {
            1: ((9, 33, 3), "2e1d9d4f6e4874c010259ee8b27c949c"
                "0b945601069b24ce371342885b37d978"),
            2: ((5, 17, 3), "0c5c4f546e793efb1a59428583476fb8"
                "ef07b1348cc6de33f6d3105adc3e93ad"),
            4: ((3, 9, 3), "2a033d1a4c4a2484a0f45b7d78043d39"
                "20299300699a62ef29497cc5d44a834c"),
            8: ((2, 5, 3), "34bdfd4ee5279719f7140ab9c0da1387"
                "a01f332a62c1dd23e6443682ba504166"),
        }),
    "tiny_5x3_420": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wAARCAAFAAMDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhBy"
        "JxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqr"
        "KztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQ"
        "J3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRom"
        "JygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiI"
        "mKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwCp5S0UUV1cqPa9pLuf/9k=",
        {
            1: ((5, 3, 3), "e3288727d81f8bf0015386b9a78ff6fb"
                "cfd9d546a6c9977b43b4be175812d782"),
            2: ((3, 2, 3), "1c157d93f642046c5139ef25eb47f311"
                "787fc351761ae7060cdaca2ff0b38569"),
            4: ((2, 1, 3), "924eb5e3e908c67b12a7b8fb82d0019b"
                "61180f5988e04235a22862533ad6e04e"),
            8: ((1, 1, 3), "3ae47a701a51892ed1d82549f87473b0"
                "4e9925ead330dd9c65d28dceb491afdc"),
        }),
    "baseline_411": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wAARCAATABcDAUEAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhBy"
        "JxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqr"
        "KztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQ"
        "J3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRom"
        "JygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiI"
        "mKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwB1nM0bNEeeKjuQZISCc4PIp1rGg6"
        "qCO/FFJzWoOkoP3hkLqshDna5ojjMkzBXyO5zQ0jW7FYyT64opxSe4VZcyuzNvmYOh"
        "yc5HNasHFnuHXHWrNnGjwZZQTnqaK58RJx28jLE6R+Z//9k=",
        {
            1: ((19, 23, 3), "2c18be150bf078b4e151779e258dd6ef"
                "b4150fdb3f0526d5ecf0cf77e7e7ef89"),
            2: ((10, 12, 3), "b0f10aa2dad3922c3de727b1cf7872e5"
                "4ec14c9d6977e87700e3bd30be4e8c32"),
            4: ((5, 6, 3), "ebe944812eb36bec096cebb72d073575"
                "9349dd19f50533c8b8b73a67aedcd804"),
            8: ((3, 3, 3), "538674b0ff35fac8309bdaeb4074d9ca"
                "b44eb8b44ede73c1f62b6cbcbece06b6"),
        }),
    "baseline_440": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw"
        "8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwL"
        "DBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMj"
        "IyMjIyMjIyMjL/wAARCAATABcDARIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAA"
        "AAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhBy"
        "JxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpT"
        "VFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqr"
        "KztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/8QA"
        "HwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQ"
        "J3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRom"
        "JygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiI"
        "mKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk"
        "5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwB1nM0bNEeeKihdVkIc7XNTUm9C6k"
        "aLVnqLcgyQkE5weRSRxmSZgr5Hc5oSlD3rjUI8vYfaxoOqgjvxTGka3YrGSfXFXrJG"
        "D5Yu6Wpm3zMHQ5OcjmitKPwM3r/GasHFnuHXHWiuKpuKO5Zs40eDLKCc9TRWeIk01Z"
        "nFidz/2Q==",
        {
            1: ((19, 23, 3), "ef5a5a4b018d1712ef373d9446c0258d"
                "8500817376a17314d8d086a72ecefb2a"),
            2: ((10, 12, 3), "b928241eb8b62f68487b4b9b263fd072"
                "bce938bcf9c131b2879bb2441af4707f"),
            4: ((5, 6, 3), "9c49d23751abf8a01887d04644c0dcb2"
                "3949481f90940935146fcbe9070c9dee"),
            8: ((3, 3, 3), "d64bbeac65157d17f53fa95b31682e46"
                "455418d1b7345454a71fb3ae8d700a31"),
        }),
    "rgb": (
        "/9j/7gAOQWRvYmUAZAAAAAAA/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB"
        "0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AAEQgAEwAXA1IR"
        "AEcRAEIRAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYHCAkKC//EALUQAAIBAw"
        "MCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNicoIJ"
        "ChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eH"
        "l6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV"
        "1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/aAAwDUgBHAEIAAD8AkTT2e2aJuBjgE0"
        "um37287wsNxxUgvvIAETELn+9UU9pL9iVCc7G6A028PnxEZ54yKpR3Q82RmIAYck1H"
        "ZWNvHOZ5FyGGOBUlqfkCBAccHjNWo2gVMx7WUnmrB1JjLj7rtxxUFnFGjMJX2SYzk1"
        "Rnd0uER0JWpIFI3I8pLMM81HFC092/lPlB945q1NHA8W0DGfSs+5meCQopJqfzHtmI"
        "iJPPJWnI0cEarGvPQ5H/ANaoNcJW8j28c9qxrl2+Rtxzkc5qoP8Aj3Ld89a1bbm3Ln"
        "72Otbdv8tiSvBKnJFRykm3Dd/X8TVWdFZFYjLEnmtTRoIpLUl0DHPepJ5XSOPa2OT2"
        "r//Z",
        {
            1: ((19, 23, 3), "0ac899714f32f12dde2308adfba306f6"
                "59f7901576d7a8289b3bc3aa7cd3ddf4"),
            2: ((10, 12, 3), "62921fc95a4fe1f8a8e3b9d9354561fe"
                "ebfe146fc9f0a3b8b7e84be30c8b08c4"),
            4: ((5, 6, 3), "44a0add0799758f6df19766b48fce3f2"
                "67de028ebbff546d866b2c21b4372723"),
            8: ((3, 3, 3), "36071626da4d750feeaa9cfd846ea998"
                "eda0d5722a129d6b2c28d0d03064d9a2"),
        }),
    "cmyk": (
        "/9j/7gAOQWRvYmUAZAAAAAAA/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB"
        "0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AAFAgAEwAXBEMR"
        "AE0RAFkRAEsRAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYHCAkKC//EALUQAA"
        "IBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNi"
        "coIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dX"
        "Z3eHl6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS"
        "09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/aAA4EQwBNAFkASwAAPwCRNPZ7Zo"
        "m4GOATS6bfvbzvCw3HFSC+8gARMQuf71e/1FPaS/YlQnOxugNNvD58RGeeMiqUd0PN"
        "kZiAGHJNFR2VjbxzmeRchhjgVJan5AgQHHB4zVqNoFTMe1lJ5oqwdSYy4+67ccVBZx"
        "RozCV9kmM5NUZ3dLhEdCVoqSBSNyPKSzDPNRxQtPdv5T5QfeOatTRwPFtAxn0orPuZ"
        "ngkKKSan8x7ZiIiTzyVpyNHBGqxrz0OR/wDWoqDXCVvI9vHPasa5dvkbcc5HOaqD/j"
        "3Ld89aK1bbm3Ln72Otbdv8tiSvBKnJFRykm3Dd/X8TRVWdFZFYjLEnmtTRoIpLUl0D"
        "HPepJ5XSOPa2OT2or//Z",
        {
            1: ((19, 23, 3), "ff72473136f6a0d3644d9c3b123ffeab"
                "8285b975d26257c839b039c47c96ff65"),
            2: ((10, 12, 3), "2f36006f710ba25e34d3ded6dc6ba9ba"
                "4783bd6074421926d793ba8911f562dd"),
            4: ((5, 6, 3), "240e8fcdd6f06b671144bb0095bbc00e"
                "95f143e04c146f7ef712cc3f7a38d9d3"),
            8: ((3, 3, 3), "2660b67a2cf25e13ebbaf73902974e12"
                "d34dd4dd866c093f4e1075eef07150e9"),
        }),
    "ycck": (
        "/9j/7gAOQWRvYmUAZAAAAAAC/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB"
        "0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AAFAgAEwAXBEMR"
        "AE0RAFkRAEsRAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYHCAkKC//EALUQAA"
        "IBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNi"
        "coIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dX"
        "Z3eHl6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS"
        "09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/aAA4EQwBNAFkASwAAPwCRNPZ7Zo"
        "m4GOATS6bfvbzvCw3HFSC+8gARMQuf71e/1FPaS/YlQnOxugNNvD58RGeeMiqUd0PN"
        "kZiAGHJNFR2VjbxzmeRchhjgVJan5AgQHHB4zVqNoFTMe1lJ5oqwdSYy4+67ccVBZx"
        "RozCV9kmM5NUZ3dLhEdCVoqSBSNyPKSzDPNRxQtPdv5T5QfeOatTRwPFtAxn0orPuZ"
        "ngkKKSan8x7ZiIiTzyVpyNHBGqxrz0OR/wDWoqDXCVvI9vHPasa5dvkbcc5HOaqD/j"
        "3Ld89aK1bbm3Ln72Otbdv8tiSvBKnJFRykm3Dd/X8TRVWdFZFYjLEnmtTRoIpLUl0D"
        "HPepJ5XSOPa2OT2or//Z",
        {
            1: ((19, 23, 3), "c044dcbd384bfecb2aa0f27b7dbfe59e"
                "f3d2e056a6e4b3149ea9602f8475505c"),
            2: ((10, 12, 3), "1efe05073943621312cc0edbe044aab4"
                "b7b7afdad86cfb7c0fdf7b5b1f45c6f2"),
            4: ((5, 6, 3), "a8480207cb08d1644e1ab46fb0a0cac6"
                "3b4b91d41c33913669b016d0f46b9822"),
            8: ((3, 3, 3), "79d792b882e1e0c80500950a398ed661"
                "abe54dcc07456298385466e4e2d9ebf1"),
        }),
}


def rgb_digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def write_fixtures(root) -> dict:
    """FIXTURES as files under `root`: {name: path}."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (b64, _) in FIXTURES.items():
        path = root / f"{name}.jpg"
        path.write_bytes(base64.b64decode(b64))
        paths[name] = str(path)
    return paths


def check_fixtures(root) -> list:
    """Decode every fixture at every scale with the core; returns the
    mismatches against cv2's digests as (name, denom, shape, digest)."""
    bad = []
    for name, path in write_fixtures(root).items():
        for denom, (shape, digest) in FIXTURES[name][1].items():
            got = nl.jpeg_decode(path, denom, orient=denom == 1)
            if got.shape != shape or rgb_digest(got) != digest:
                bad.append((name, denom, got.shape, rgb_digest(got)))
    return bad


def with_exif_orientation(jpeg: bytes, orientation: int,
                          little_endian: bool = True) -> bytes:
    """`jpeg` with an APP1 Exif block (TIFF IFD0 holding tag 0x0112 =
    orientation) spliced in after SOI."""
    bo = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM")
            + struct.pack(bo + "HIH", 42, 8, 1)
            + struct.pack(bo + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(bo + "I", 0))
    body = b"Exif\0\0" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body \
        + jpeg[2:]


def _cv2():
    import cv2
    return cv2


def _pil():
    return pytest.importorskip("PIL.Image")


def _image(rng, h, w, blur, grey=False):
    cv2 = _cv2()
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    if blur and min(h, w) >= 5:
        img = cv2.GaussianBlur(img, (5, 5), 2)
    return img[..., 0] if grey else img


def _kinds():
    cv2 = _cv2()
    s, prog = cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_PROGRESSIVE
    rst = cv2.IMWRITE_JPEG_RST_INTERVAL
    f420 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420
    f422 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422
    f444 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444
    f411 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411
    f440 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440
    return {  # name: (imwrite params, grey); PIL_KINDS are Pillow's
        "baseline_411": ([s, f411], False),
        "baseline_440": ([s, f440], False),
        "progressive_411": ([prog, 1, s, f411], False),
        "progressive_440": ([prog, 1, s, f440], False),
        "baseline_420": ([s, f420], False),
        "baseline_422": ([s, f422], False),
        "baseline_444": ([s, f444], False),
        "grey": ([], True),
        "progressive_420": ([prog, 1, s, f420], False),
        "progressive_444": ([prog, 1, s, f444], False),
        "progressive_grey": ([prog, 1], True),
        "restart_420": ([rst, 3, s, f420], False),
        "progressive_restart_422": ([prog, 1, rst, 2, s, f422], False),
    }


# Pillow's writers: RGB colour (an Adobe APP14 of transform 0, no JFIF)
# and CMYK (Adobe transform 0); ycck is the cmyk file with transform 2
PIL_KINDS = ("rgb", "cmyk", "ycck")
KINDS = ["baseline_420", "baseline_422", "baseline_444", "grey",
         "progressive_420", "progressive_444", "progressive_grey",
         "restart_420", "progressive_restart_422", "baseline_411",
         "baseline_440", "progressive_411", "progressive_440", *PIL_KINDS]
# (h, w): partial MCUs at both edges, a COCO-like size, chroma <= 2 wide
SIZES = [(29, 37), (427, 641), (5, 3), (9, 33), (16, 17)]


def _write(path, img, quality, params):
    cv2 = _cv2()
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, quality]
                       + params)
    return str(path)


def _write_pil(path, img, quality, kind):
    """A PIL_KINDS file of the RGB image `img`."""
    Image = _pil()
    im = Image.fromarray(np.ascontiguousarray(img))
    if kind == "rgb":
        im.save(str(path), quality=quality, keep_rgb=True)
        return str(path)
    im.convert("CMYK").save(str(path), quality=quality)
    if kind == "ycck":
        data = bytearray(Path(path).read_bytes())
        app14 = _segment(data, 0xEE)
        assert data[app14 + 4:app14 + 9] == b"Adobe" and data[app14 + 15] == 0
        data[app14 + 15] = 2
        Path(path).write_bytes(bytes(data))
    return str(path)


def _write_kind(path, kind, img, quality):
    if kind in PIL_KINDS:
        return _write_pil(path, img, quality, kind)
    return _write(path, img, quality, _kinds()[kind][0])


def _cv2_read(path, denom=1):
    cv2 = _cv2()
    flags = {1: cv2.IMREAD_COLOR,
             2: cv2.IMREAD_REDUCED_COLOR_2 | cv2.IMREAD_IGNORE_ORIENTATION,
             4: cv2.IMREAD_REDUCED_COLOR_4 | cv2.IMREAD_IGNORE_ORIENTATION,
             8: cv2.IMREAD_REDUCED_COLOR_8 | cv2.IMREAD_IGNORE_ORIENTATION}
    return cv2.imread(str(path), flags[denom])[:, :, ::-1]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixtures_decode_to_cv2s_digests(name, tmp_path):
    path = write_fixtures(tmp_path)[name]
    for denom, (shape, digest) in FIXTURES[name][1].items():
        got = nl.jpeg_decode(path, denom, orient=denom == 1)
        assert (got.shape, rgb_digest(got)) == (shape, digest), denom


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_digests_are_cv2_imread(name, tmp_path):
    path = write_fixtures(tmp_path)[name]
    for denom, (shape, digest) in FIXTURES[name][1].items():
        want = _cv2_read(path, denom)
        assert (want.shape, rgb_digest(want)) == (shape, digest), denom


@pytest.mark.parametrize("quality", [50, 75, 90, 95])
@pytest.mark.parametrize("kind", KINDS)
def test_decoder_is_cv2_imread(kind, quality, tmp_path):
    grey = kind not in PIL_KINDS and _kinds()[kind][1]
    rng = np.random.default_rng(quality)
    for h, w in SIZES:
        for blur in (False, True):
            path = _write_kind(tmp_path / f"{h}x{w}{blur}.jpg", kind,
                               _image(rng, h, w, blur, grey), quality)
            want = _cv2_read(path)
            np.testing.assert_array_equal(image_io.imread(path), want,
                                          err_msg=f"{h}x{w} blur {blur}")
            assert image_io.image_size(path) == (w, h)


@pytest.mark.parametrize("denom", [2, 4, 8])
def test_prescale_is_cv2s_reduced_read(denom, tmp_path):
    rng = np.random.default_rng(denom)
    for kind in KINDS:
        grey = kind not in PIL_KINDS and _kinds()[kind][1]
        for h, w in SIZES:
            path = _write_kind(tmp_path / f"{kind}{h}x{w}.jpg", kind,
                               _image(rng, h, w, True, grey), 90)
            np.testing.assert_array_equal(
                nl.jpeg_decode(path, denom, orient=False),
                _cv2_read(path, denom), err_msg=f"{kind} {h}x{w}")


def test_letterbox_prescale_picks_the_jax_cores_scale(tmp_path):
    """The prescale route decodes at the largest 1/d keeping both sides
    >= 2x the target, then resizes (cv2 INTER_LINEAR)."""
    cv2 = _cv2()
    rng = np.random.default_rng(3)
    path = _write(tmp_path / "a.jpg", _image(rng, 427, 641, True), 90, [])
    for new_w, new_h, denom in [(400, 267, 1), (300, 200, 2), (160, 106, 4),
                                (80, 53, 8)]:
        got = np.empty((new_h, new_w, 3), np.uint8)
        nl.jpeg_letterbox(path, got, 0, 0, new_w, new_h, pad_value=-1,
                          expect_wh=(641, 427), prescale=True)
        want = cv2.resize(np.ascontiguousarray(_cv2_read(path, denom)),
                          (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, want, err_msg=str(denom))


@pytest.mark.parametrize("kind", ["baseline_411", "progressive_440",
                                  *PIL_KINDS])
def test_new_kinds_through_the_letterbox_and_exif(kind, tmp_path):
    """The 4:1:1, 4:4:0, RGB, CMYK and YCCK kinds go through the fused
    decode + letterbox (both routes: the prescale's 1/d decode, and full
    size with the EXIF orientation) as cv2.imread + cv2.resize do."""
    cv2 = _cv2()
    rng = np.random.default_rng(len(kind))
    path = _write_kind(tmp_path / "a.jpg", kind, _image(rng, 213, 321, True),
                       90)
    for new_w, new_h, denom in [(150, 99, 2), (80, 53, 4), (40, 26, 8)]:
        got = np.empty((new_h, new_w, 3), np.uint8)
        nl.jpeg_letterbox(path, got, 0, 0, new_w, new_h, pad_value=-1,
                          expect_wh=(321, 213), prescale=True)
        want = cv2.resize(np.ascontiguousarray(_cv2_read(path, denom)),
                          (new_w, new_h), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, want, err_msg=str(denom))
    turned = tmp_path / "o.jpg"
    turned.write_bytes(with_exif_orientation(Path(path).read_bytes(), 6))
    want = _cv2_read(turned)
    np.testing.assert_array_equal(image_io.imread(str(turned)), want)
    canvas = np.empty((160, 107, 3), np.uint8)
    nl.jpeg_letterbox(str(turned), canvas, 0, 0, 107, 160, pad_value=-1,
                      expect_wh=(213, 321))
    np.testing.assert_array_equal(
        canvas, cv2.resize(np.ascontiguousarray(want), (107, 160),
                           interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("little_endian", [True, False])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_cv2s(orientation, little_endian, tmp_path):
    cv2 = _cv2()
    rng = np.random.default_rng(orientation)
    ok, buf = cv2.imencode(".jpg", _image(rng, 30, 50, True))
    path = tmp_path / "o.jpg"
    path.write_bytes(with_exif_orientation(buf.tobytes(), orientation,
                                           little_endian))
    want = _cv2_read(path)
    got = image_io.imread(str(path))
    np.testing.assert_array_equal(got, want)
    assert image_io.image_size(str(path)) == (want.shape[1], want.shape[0])
    assert nl.jpeg_info(str(path)) == (50, 30, orientation)
    # the letterbox path orients as imread does, before its resize
    canvas = np.full((64, 64, 3), 7, np.uint8)
    nh, nw = want.shape[0] * 64 // max(want.shape[:2]), \
        want.shape[1] * 64 // max(want.shape[:2])
    nl.jpeg_letterbox(str(path), canvas, 0, 0, nw, nh, pad_value=114,
                      expect_wh=(want.shape[1], want.shape[0]))
    np.testing.assert_array_equal(
        canvas[:nh, :nw],
        cv2.resize(np.ascontiguousarray(want), (nw, nh),
                   interpolation=cv2.INTER_LINEAR))
    with pytest.raises(OSError, match="labels cache"):
        nl.jpeg_letterbox(str(path), canvas, 0, 0, nw, nh,
                          expect_wh=(want.shape[0] + 1, want.shape[1]))


@pytest.mark.parametrize("variant,orientation", [
    ("bad_magic", 1), ("truncated", 1), ("out_of_range", 1),
    ("xmp_app1_first", 6), ("stored_as_long", 6)])
def test_exif_block_variants_read_as_cv2_reads_them(variant, orientation,
                                                     tmp_path):
    """A malformed block means orientation 1; an XMP APP1 before the Exif
    one, or the tag stored as a LONG, still orients (cv2 reads them so)."""
    cv2 = _cv2()
    rng = np.random.default_rng(9)
    jpeg = cv2.imencode(".jpg", _image(rng, 30, 50, True))[1].tobytes()
    data = with_exif_orientation(jpeg, 6)

    def app1(body):
        return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
    if variant == "bad_magic":
        data = data.replace(b"II*\x00", b"II+\x00", 1)
    elif variant == "truncated":
        data = jpeg[:2] + app1(b"Exif\0\0II*\x00") + jpeg[2:]
    elif variant == "out_of_range":
        data = with_exif_orientation(jpeg, 9)
    elif variant == "xmp_app1_first":
        data = data[:2] + app1(b"http://ns.adobe.com/xap/1.0/\0<x/>") \
            + data[2:]
    else:
        data = data.replace(b"\x12\x01\x03\x00", b"\x12\x01\x04\x00", 1)
    path = tmp_path / "m.jpg"
    path.write_bytes(data)
    assert nl.jpeg_info(str(path))[2] == orientation
    np.testing.assert_array_equal(image_io.imread(str(path)),
                                  _cv2_read(path))


@pytest.mark.parametrize("quality", [50, 75, 90, 95, 100])
def test_writer_files_decode_identically(quality, tmp_path):
    cv2 = _cv2()
    rng = np.random.default_rng(quality)
    for h, w in [(29, 37), (427, 641), (1, 1), (17, 33)]:
        img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                               (5, 5), 2) if min(h, w) >= 5 else \
            rng.integers(0, 256, (h, w, 3), np.uint8)
        path = str(tmp_path / f"w{h}x{w}.jpg")
        nl.jpeg_write(path, img, quality)
        got = image_io.imread(path)
        np.testing.assert_array_equal(got, _cv2_read(path))
        if h > 100:  # a baseline 4:2:0 JFIF file, as close as cv2's own
            data = Path(path).read_bytes()
            sof = data.index(b"\xff\xc0")
            assert data[sof + 10:sof + 19] == \
                b"\x01\x22\x00\x02\x11\x01\x03\x11\x01"
            ref = str(tmp_path / "ref.jpg")
            cv2.imwrite(ref, img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY,
                                               quality])
            err = np.abs(got.astype(int) - img).mean()
            ref_err = np.abs(_cv2_read(ref).astype(int) - img).mean()
            assert err <= ref_err * 1.05 + 0.05, (err, ref_err)


def _segment(data: bytes, marker: int) -> int:
    """Offset of the first `marker` segment (0xFFxx) in the headers."""
    pos = 2
    while data[pos + 1] != marker:
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return pos


def _unsupported(kind: str, tmp_path) -> bytes:
    """A file of each kind the decoder once refused: real files from the
    tests' writers (tests/jpeg_writers.py), cv2's and Pillow's."""
    import jpeg_writers as jw

    cv2 = _cv2()
    rng = np.random.default_rng(4)
    img = _image(rng, 24, 40, True)
    s = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    if kind in ("sampling_411", "sampling_440"):
        factor = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411 if kind.endswith("411")
                  else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
        return cv2.imencode(".jpg", img, [s, factor])[1].tobytes()
    if kind in ("cmyk", "rgb"):
        path = tmp_path / f"{kind}.jpg"
        return Path(_write_pil(path, img, 75, kind)).read_bytes()
    if kind in ("sampling_fractional", "sampling_11_blocks"):
        factors = SAMPLING_SETS[kind]
        return encode_baseline([img[..., c] for c in range(3)], factors)
    if kind == "unrefined_progressive":
        data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                          1])[1].tobytes()
        scans = [i for i in range(len(data) - 1)
                 if data[i] == 0xFF and data[i + 1] == 0xDA]
        return data[:scans[3]] + b"\xff\xd9"  # the first three scans only
    planes = [img[..., c] for c in range(3)]
    if kind == "arithmetic":  # SOF9, the tests' QM coder
        return jw.encode(planes, [(1, 1)] * 3, arith=True, adobe=0)
    if kind == "lossless":  # SOF3 RGB, predictor 1
        return jw.encode_lossless(planes)
    if kind == "hierarchical":  # DHP, a baseline frame, EXP, SOF5
        return jw.encode_hierarchical(planes[0])
    if kind == "precision_12":  # SOF1 of 12-bit samples
        return jw.encode([p.astype(np.int64) * 16 for p in planes],
                         [(1, 1)] * 3, precision=12)
    data = bytearray(cv2.imencode(".jpg", img)[1].tobytes())
    sof = _segment(data, 0xC0)
    n = struct.unpack(">H", data[sof + 2:sof + 4])[0]
    body = bytes(data[sof + 4:sof + 9]) + b"\x02" + b"".join(
        bytes([c, 0x11, 0]) for c in (1, 2))
    data[sof:sof + 2 + n] = b"\xff\xc0" + struct.pack(
        ">H", len(body) + 2) + body
    return bytes(data)   # components_2


UNSUPPORTED = {"arithmetic": "arithmetic coding",
               "precision_12": "precision",
               "lossless": "lossless", "hierarchical": "hierarchical",
               "components_2": "neither 1, 3 nor 4 components",
               "sampling_fractional": "sampling factors",
               "sampling_11_blocks": "sampling factors",
               "unrefined_progressive": "unrefined"}
# kinds the decoder refused before it read them: their cases hold that the
# dataset now builds and reads them as cv2.imread does
READ_NOW = ("cmyk", "rgb", "sampling_411", "sampling_440", "arithmetic",
            "lossless", "unrefined_progressive")
# kinds libjpeg refuses too (cv2.imread returns None): the file leaves the
# dataset, as it leaves JAX's (ROADMAP F10)
CV2_REFUSES_TOO = ("components_2", "sampling_fractional",
                   "sampling_11_blocks", "precision_12", "hierarchical")


@pytest.mark.parametrize("kind", sorted(UNSUPPORTED) + sorted(
    set(READ_NOW) - set(UNSUPPORTED)))
def test_unsupported_kinds_raise_at_dataset_build(kind, tmp_path):
    """Every kind the decoder once refused is now read as cv2 reads it or,
    where libjpeg refuses it too, dropped as JAX's dataset drops it: no
    JPEG kind cv2 reads raises."""
    assert (kind in READ_NOW) != (kind in CV2_REFUSES_TOO)
    good = tmp_path / "images" / "good.jpg"
    good.parent.mkdir()
    nl.jpeg_write(str(good), np.full((24, 40, 3), 90, np.uint8), 90)
    bad = tmp_path / "images" / f"{kind}.jpg"
    bad.write_bytes(_unsupported(kind, tmp_path))
    lst = tmp_path / "list.txt"
    lst.write_text(f"{good}\n{bad}\n")
    if kind in CV2_REFUSES_TOO:
        jax_ds = pytest.importorskip("efficientteacher_tpu.data.datasets")
        assert _cv2().imread(str(bad)) is None
        assert jax_ds.verify_image_label(str(bad), None, 8) is None
        assert port_ds.verify_image_label(str(bad), None, 8) is None
        ds = port_ds.LoadImagesAndLabels(str(lst), img_size=32, nc=8)
        assert ds.img_files == [str(good)]
        with pytest.raises(OSError, match=UNSUPPORTED[kind]):
            image_io.image_size(str(bad))
        return
    ds = port_ds.LoadImagesAndLabels(str(lst), img_size=32, nc=8)
    assert list(map(tuple, ds.shapes)) == [(40, 24), (40, 24)]
    np.testing.assert_array_equal(image_io.imread(str(bad)), _cv2_read(bad))


# -- every sampling set ---------------------------------------------------

def _huffman_codes(bits, vals):
    """{symbol: (code, length)} of a DHT table (ITU T.81 C.2)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


_STD = {  # (DC bits, DC values, AC bits, AC values) per table
    0: ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)),
        [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
    1: ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)),
        [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])}
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
                    37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                    54, 47, 55, 62, 63])


def _std_ac_values(table):
    """The standard AC symbols in jstdhuff.c's order (K.3.3.2)."""
    order = [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31,
             0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32,
             0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
             0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
             0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A]
    if table == 1:
        order = [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06,
                 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81,
                 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
                 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
                 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28,
                 0x29, 0x2A]
    seen = set(order)
    # the rest: runs 0-15 x sizes 3-10 (table 0) in (run, size) order,
    # then what the fixed prefix left out
    rest = []
    for r in range(16):
        for sz in range(1, 11):
            v = (r << 4) | sz
            if v not in seen:
                rest.append(v)
    return order + rest


def encode_baseline(planes, factors, ids=None, adobe=None, q=4):
    """A baseline JPEG of the components `planes` (each (h, w) uint8, full
    size; stored as they are: YCbCr, RGB, CMYK or YCCK by the markers)
    sampled with `factors` ((h, v) each): point downsampling,
    a float DCT, a flat quantisation table of `q`, libjpeg's standard
    Huffman tables, one interleaved scan. `ids` are the component ids
    (1, 2, ...); `adobe` writes an APP14 with that transform."""
    h, w = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    k = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    comps = []
    for plane, (ch, cv) in zip(planes, factors):
        big = np.pad(plane.astype(np.float64),
                     ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)),
                     mode="edge")
        rows = np.arange(mcuy * 8 * cv) * vmax // cv
        cols = np.arange(mcux * 8 * ch) * hmax // ch
        small = big[rows][:, cols]
        blocks = small.reshape(mcuy * cv, 8, mcux * ch, 8).transpose(0, 2, 1,
                                                                      3)
        coef = np.rint(dct @ (blocks - 128) @ dct.T / q).astype(int)
        comps.append(coef.reshape(*coef.shape[:2], 64)[..., _ZIGZAG].tolist())
    tables = {}
    for t, (dcb, dcv, acb) in _STD.items():
        tables[t] = (_huffman_codes(dcb, dcv),
                     _huffman_codes(acb, _std_ac_values(t)[:sum(acb)]),
                     dcb, dcv, acb, _std_ac_values(t)[:sum(acb)])
    out, acc, nacc = bytearray(), 0, 0

    def put(code, length):
        nonlocal acc, nacc
        acc, nacc = (acc << length) | code, nacc + length
        while nacc >= 8:
            byte = (acc >> (nacc - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def magnitude(v):
        size = int(abs(v)).bit_length()
        return size, (v if v >= 0 else v + (1 << size) - 1)

    preds = [0] * len(planes)
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (ch, cv) in enumerate(factors):
                dc_codes, ac_codes = tables[min(c, 1)][:2]
                for by in range(cv):
                    for bx in range(ch):
                        blk = comps[c][my * cv + by][mx * ch + bx]
                        size, bits = magnitude(blk[0] - preds[c])
                        preds[c] = blk[0]
                        put(*dc_codes[size])
                        put(bits, size)
                        run = 0
                        for v in blk[1:]:
                            if not v:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac_codes[0xF0])
                                run -= 16
                            size, bits = magnitude(v)
                            put(*ac_codes[(run << 4) | size])
                            put(bits, size)
                            run = 0
                        if run:
                            put(*ac_codes[0x00])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    head = b"\xff\xd8"
    if adobe is not None:
        head += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    head += seg(0xDB, b"".join(bytes([t]) + bytes([q] * 64) for t in (0, 1)))
    head += seg(0xC0, struct.pack(">BHHB", 8, h, w, n) + b"".join(
        bytes([ids[c], (f[0] << 4) | f[1], min(c, 1)])
        for c, f in enumerate(factors)))
    for t, (_, _, dcb, dcv, acb, acv) in tables.items():
        head += seg(0xC4, bytes([t]) + bytes(dcb) + bytes(dcv))
        head += seg(0xC4, bytes([0x10 | t]) + bytes(acb) + bytes(acv))
    head += seg(0xDA, bytes([n]) + b"".join(
        bytes([ids[c], min(c, 1) * 0x11]) for c in range(n)) + b"\x00\x3f\x00")
    return bytes(head + out + b"\xff\xd9")


# name: (h, v) of each component; the last four are refused by libjpeg
SAMPLING_SETS = {
    "h1v4": ((1, 4), (1, 1), (1, 1)), "h4v2": ((4, 2), (1, 1), (1, 1)),
    "h2v4": ((2, 4), (1, 1), (1, 1)), "h3v1": ((3, 1), (1, 1), (1, 1)),
    "h1v3": ((1, 3), (1, 1), (1, 1)), "h3v2": ((3, 2), (1, 1), (1, 1)),
    "chroma_h1v2": ((2, 2), (2, 1), (2, 1)),
    "chroma_h2v1": ((2, 2), (1, 2), (1, 2)),
    "chroma_h2v1_of_h4": ((4, 1), (2, 1), (2, 1)),
    "luma_upsampled": ((1, 1), (2, 2), (2, 2)),
    "mixed_chroma": ((2, 2), (2, 2), (1, 1)),
    "cmyk_h2v2": ((2, 2), (1, 1), (1, 1), (2, 2)),
    "ycck_h2v1": ((2, 1), (1, 1), (1, 1), (2, 1)),
    "sampling_fractional": ((3, 1), (2, 1), (2, 1)),
    "sampling_11_blocks": ((3, 3), (1, 1), (1, 1)),
    "sampling_18_blocks": ((4, 4), (1, 1), (1, 1)),
    "cmyk_12_blocks": ((2, 2), (2, 2), (1, 1), (2, 2)),
}
_REFUSED_SETS = ("sampling_fractional", "sampling_11_blocks",
                 "sampling_18_blocks", "cmyk_12_blocks")


@pytest.mark.parametrize("name", sorted(SAMPLING_SETS))
def test_every_sampling_set_is_cv2_imread(name, tmp_path):
    """The test's own encoder writes each sampling set (Adobe transform 0
    for the CMYK set, 2 for the YCCK one); the decoder equals cv2 at
    scales 1, 1/2, 1/4, 1/8, and the sets libjpeg refuses raise."""
    cv2 = _cv2()
    factors = SAMPLING_SETS[name]
    adobe = {"cmyk": 0, "ycck": 2}.get(name[:4])
    rng = np.random.default_rng(len(name))
    for h, w in [(29, 37), (5, 3), (16, 17), (9, 33), (40, 64)]:
        img = _image(rng, h, w, True)
        planes = [img[..., c % 3] for c in range(len(factors))]
        path = tmp_path / f"{name}{h}x{w}.jpg"
        path.write_bytes(encode_baseline(planes, factors, adobe=adobe))
        if name in _REFUSED_SETS:
            assert cv2.imread(str(path)) is None   # libjpeg refuses it too
            with pytest.raises(OSError, match="sampling"):
                image_io.image_size(str(path))
            continue
        assert image_io.image_size(str(path)) == (w, h)
        for denom in (1, 2, 4, 8):
            np.testing.assert_array_equal(
                nl.jpeg_decode(str(path), denom, orient=False),
                _cv2_read(path, denom), err_msg=f"{h}x{w} 1/{denom}")


def test_damaged_files_raise_and_never_crash(tmp_path):
    """Seeded damage to the fixtures (bytes overwritten, truncation,
    garbage inserted): every read returns an image or raises OSError; none
    takes the process down. A file cut short reads as cv2.imread reads it
    (ROADMAP F12: the data after the cut read as zero bits, the MCUs after
    it skipped)."""
    cv2 = _cv2()
    rng = np.random.default_rng(0)
    sources = [Path(p).read_bytes()
               for p in write_fixtures(tmp_path / "fx").values()]
    path = str(tmp_path / "damaged.jpg")
    outcomes = set()
    for i in range(400):
        data = bytearray(sources[i % len(sources)])
        at = int(rng.integers(2, len(data)))
        kind = i % 3
        if kind == 0:
            for _ in range(int(rng.integers(1, 6))):
                data[int(rng.integers(2, len(data)))] = int(
                    rng.integers(0, 256))
        elif kind == 1:
            data = data[:at]
        else:
            data[at:at] = rng.integers(0, 256, int(rng.integers(1, 40)),
                                       np.uint8).tobytes()
        Path(path).write_bytes(bytes(data))
        try:
            img = image_io.imread(path)
            assert img.shape[2] == 3 and img.shape[:2] == \
                image_io.image_size(path)[::-1]
            outcomes.add("read")
        except OSError:
            img = None
            outcomes.add("corrupt")
        if kind == 1:
            want = cv2.imread(path)
            assert (img is None) == (want is None), at
            if img is not None:
                np.testing.assert_array_equal(img, want[:, :, ::-1])
    assert outcomes == {"read", "corrupt"}
