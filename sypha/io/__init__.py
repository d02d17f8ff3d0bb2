from sypha.io.scp_reader import read_scp_file, parse_scp_text
from sypha.io.standard_form import scp_standard_form, pad_lp, stack_lps

__all__ = [
    "read_scp_file",
    "parse_scp_text",
    "scp_standard_form",
    "pad_lp",
    "stack_lps",
]
