"""Token sentinels and action vocabulary.

Behavioral parity with the reference's token constants
(reference: streamvln/utils/utils.py:8-16) and action mapping
(reference: streamvln/streamvln_eval.py:106-111).
"""

# Label value ignored by the cross-entropy loss.
IGNORE_INDEX = -100
# Sentinel placed in input_ids where a frame's vision tokens get spliced in.
IMAGE_TOKEN_INDEX = -200
# Sentinel for the slow-memory expansion (num_history pooled frames).
MEMORY_TOKEN_INDEX = -300

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_MEMORY_TOKEN = "<memory>"
DEFAULT_VIDEO_TOKEN = "<video>"

# Discrete VLN-CE action space: index -> (name, text glyph).
ACTION_STOP = 0
ACTION_FORWARD = 1   # move forward 25 cm
ACTION_LEFT = 2      # turn left 15 degrees
ACTION_RIGHT = 3     # turn right 15 degrees

# Text glyphs the LLM emits / parses (reference: streamvln_eval.py:106-111).
ACTIONS_TO_IDX = {
    "STOP": 0,
    "↑": 1,  # ↑
    "←": 2,  # ←
    "→": 3,  # →
}
IDX_TO_ACTION_TEXT = {0: "STOP", 1: "↑", 2: "←", 3: "→"}

# Random conjunctions prepended to the per-round <image> prompt
# (reference: streamvln_eval.py:112-120, vln_action_dataset.py:670-678).
CONJUNCTIONS = (
    "you can see ",
    "in front of you is ",
    "there is ",
    "you can spot ",
    "you are toward the ",
    "ahead of you is ",
    "in your sight is ",
)

SYSTEM_MESSAGE = "You are a helpful assistant."

# Base navigation prompt (reference: streamvln_eval.py:103; the '<video>\n'
# prefix is stripped and the trailing clause appended before tokenization,
# streamvln_eval.py:293-297).
NAV_PROMPT = (
    "You are an autonomous navigation assistant. Your task is to "
    "<instruction>. Devise an action sequence to follow the instruction "
    "using the four actions: TURN LEFT (←) or TURN RIGHT (→) by 15 "
    "degrees, MOVE FORWARD (↑) by 25 centimeters, or STOP."
)
NAV_PROMPT_SUFFIX = (
    " Please devise an action sequence to follow the instruction which may "
    "include turning left or right by a certain degree, moving forward by a "
    "certain distance or stopping once the task is complete."
)
MEMORY_PROMPT_EVAL = " These are your historical observations {}."
MEMORY_PROMPT_TRAIN = " These are your historical observations: {}."
MEMORY_PROMPT_AGENT = " You have visited these areas {}."
