"""Core constants for sregex-tpu.

Status codes and flags mirror the reference public API
(reference src/sregex/sregex.h:65-72,91-94); assertion bits mirror
sre_regex.h:35-53; opcodes mirror sre_vm_bytecode.h:18-28.
"""

# Status codes (sregex.h:65-72)
SRE_OK = 0
SRE_ERROR = -1
SRE_AGAIN = -2
SRE_BUSY = -3
SRE_DONE = -4
SRE_DECLINED = -5

# Regex compile flags (sregex.h:91-94), applied at parse time
SRE_REGEX_CASELESS = 0x01
SRE_REGEX_NEWLINE = 0x02

# Assertion bits (sre_regex.h:35-43)
SRE_REGEX_ASSERT_SMALL_Z = 0x01   # \z
SRE_REGEX_ASSERT_DOLLAR = 0x02    # $
SRE_REGEX_ASSERT_BIG_B = 0x04     # \B
SRE_REGEX_ASSERT_SMALL_B = 0x08   # \b
SRE_REGEX_ASSERT_BIG_A = 0x10     # \A
SRE_REGEX_ASSERT_CARET = 0x20     # ^

# Assertion groupings (sre_regex.h:46-53)
SRE_REGEX_ASSERT_LOOKAHEAD = (SRE_REGEX_ASSERT_SMALL_Z
                              | SRE_REGEX_ASSERT_DOLLAR
                              | SRE_REGEX_ASSERT_BIG_B
                              | SRE_REGEX_ASSERT_SMALL_B)
SRE_REGEX_ASSERT_WORD_BOUNDARY = (SRE_REGEX_ASSERT_SMALL_B
                                  | SRE_REGEX_ASSERT_BIG_B)

# Opcodes (sre_vm_bytecode.h:18-28)
OP_CHAR = 1
OP_MATCH = 2
OP_JMP = 3
OP_SPLIT = 4
OP_ANY = 5
OP_SAVE = 6
OP_IN = 7
OP_NOTIN = 8
OP_ASSERT = 9


def sre_isword(c):
    """Word-character test (sre_core.h:31-35): [0-9A-Za-z_]."""
    return (48 <= c <= 57) or (65 <= c <= 90) or (97 <= c <= 122) or c == 95
