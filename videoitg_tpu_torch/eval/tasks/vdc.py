"""VDC: Video Detailed Captioning (short / detailed / background /
main_object / camera subtasks), LLM-evaluated.

Parity: lmms_eval/tasks/vdc/ over wchai/lmms_VDC_test — docs carry
video_name (no extension) / caption / qa_list (question-answer pairs
derived from the gold caption). Each subtask prompts with one of its
caption-style instructions (utils.py:51-160 prompt pools; the reference
draws with random.choice — DIVERGENCE: here the choice is deterministic
per doc, crc32(video_name) mod pool size, so runs are reproducible).
Scoring (utils.py:200-305) is two-phase through the judge backend:
(1) answer each qa_list question FROM the predicted caption
(gener_pred_response messages, verbatim), (2) score that answer against
the gold answer with the generic yes/no + 0-5 payload (gener_pred_score
— byte-identical to the activitynetqa messages). Per-doc score/acc are
the means over its qa_list; task metrics are the means over docs
(vdc_aggregate_score/acc, utils.py:322-345). The reference drives an
sglang endpoint; eval/judge.py's http:/hf:/exact-match backends replace
it (the offline stand-in answers caption questions by best-overlap
sentence extraction).
"""

from __future__ import annotations

import ast
import os
import zlib
from typing import Dict, List

from videoitg_tpu_torch.eval.api import Task, register_group, register_task
from videoitg_tpu_torch.eval.judge import get_judge
from videoitg_tpu_torch.eval.tasks.activitynetqa import judge_messages

GEN_SYSTEM = (
    "You are an intelligent chatbot designed for providing accurate "
    "answers to questions related to the content based on a detailed "
    "description of a video or image."
    "Here's how you can accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Read the detailed description carefully.\n"
    "- Answer the question only based on the detailed description.\n"
    "- The answer should be a short sentence or phrase.\n")

# One prompt pool per subtask — the FULL reference pools, entry-for-entry
# (utils.py:51-160: DETAILED 24, BACKGROUND 16, SHORT 16, MAIN_OBJECT 16,
# CAMERA 16), so deterministic per-doc selection draws from the same
# distribution the reference samples randomly.
SHORT_PROMPTS = [
    'Write a one-sentence summary of the video.',
    'Summarize the video in one concise sentence.',
    'Provide a brief description of the video in one sentence.',
    'Describe the main action in the video in one sentence.',
    'What is the video about? Summarize it in one sentence.',
    'In one sentence, summarize the key visual elements of the video.',
    'Provide a one-sentence summary that captures the main subject and '
    'action in the video.',
    'Write a concise one-sentence description that encapsulates the '
    'essence of the video.',
    'Describe the main theme or action of the video in a single sentence.',
    'What is happening in the video? Provide a one-sentence summary.',
    'Given these frames, write a brief one-sentence summary that '
    "captures the essence of the video's visual and artistic style.",
    'Summarize the key visual and thematic elements of the video in '
    'one concise sentence.',
    'Provide a one-sentence description that highlights the main '
    'subject and action depicted in the video.',
    'In one sentence, describe the primary visual and artistic '
    'elements of the video.',
    'Write a concise one-sentence summary that encapsulates the main '
    'action and visual style of the video.',
    'Briefly one-sentence Summary of the visual, Photographic and '
    'artistic style.',
]

DETAILED_PROMPTS = [
    'Please imagine the video based on the sequence of frames, and '
    'provide a faithfully detailed description of this video in more '
    'than three sentences.',
    'You are given a sequence of equally spaced video frames. Based on '
    'these frames, imagine the full video and provide a detailed '
    'description of what is happening in more than three sentences.',
    'The following set contains equally spaced video frames. Imagine '
    'the video from which these frames were taken and describe it in '
    'detail in at least three sentences.',
    'Below are equally spaced frames from a video. Use these frames to '
    'visualize the entire video and provide a detailed description in '
    'more than three sentences.',
    'A sequence of equally spaced video frames is presented. Please '
    'imagine the full video and write a faithfully detailed '
    'description of the events in more than three sentences.',
    'The images provided include equally spaced frames from a video. '
    'Based on these frames, imagine the video and describe it '
    'comprehensively in at least three sentences.',
    'You are given equally spaced frames from a video. Use these '
    'frames to envision the entire video and provide a detailed '
    'description of the events in more than three sentences.',
    'The sequence includes equally spaced frames from a video. Imagine '
    'the full video based on these frames and provide a detailed '
    'description in more than three sentences.',
    'The provided images contain equally spaced frames from a video. '
    'Visualize the video from these frames and describe it in detail '
    'in more than three sentences.',
    'Here are equally spaced frames from a video. Based on these '
    'frames, imagine the video and provide a detailed, faithful '
    'description of it in more than three sentences.',
    'The set of images includes equally spaced video frames. Please '
    'imagine the video these frames come from and describe it '
    'comprehensively in at least three sentences.',
    'Describe the video based on these frames in a few sentences.',
    'What is happening in the video shown in these frames?',
    'Explain the video using these frames.',
    'Imagine the video from these frames and describe it in detail in '
    'a few sentences.',
    'Based on these frames, provide a narrative of the video in more '
    'than three sentences.',
    'Describe the events in the video shown by these frames in at '
    'least three sentences.',
    'Visualize the video from these frames and explain what is '
    'happening in more than three sentences.',
    'Describe the sequence of events in the video depicted by these '
    'frames in a detailed manner.',
    'Given these equally spaced frames, imagine the entire video and '
    'provide a detailed description of the events, including the '
    'setting, characters, and actions, in more than three sentences.',
    'Visualize the video based on these frames and write a '
    'comprehensive description of what happens, describing the '
    'beginning, middle, and end in at least three sentences.',
    'Using these frames as a reference, imagine the full video and '
    'provide a thorough description of the plot, including key details '
    'and actions, in more than three sentences.',
    'Based on the sequence of these frames, describe the entire video '
    'in detail, mentioning important aspects such as the context, '
    'movements, and transitions in more than three sentences.',
    'Imagine the video that corresponds to these frames and provide an '
    'elaborate description, covering the storyline, visual elements, '
    'and any notable features in at least three sentences.',
]

BACKGROUND_PROMPTS = [
    'The images are given containing equally spaced video '
    'frames.Summary of the background. This should also include the '
    'objects, location, weather, and time.',
    'Describe the background, including objects, location, weather, '
    'and time.',
    'Summarize the background setting of the video based on these frames.',
    'What is the environment like in these frames?',
    'Describe the location and weather in these frames.',
    'What background objects and settings are visible in these frames?',
    'Summarize the background of the video, including details about '
    'the location, objects, weather, and time.',
    'Describe the environment shown in these frames, covering objects, '
    'location, weather, and time.',
    'Provide a detailed background description based on these frames, '
    'mentioning objects, location, weather, and time.',
    'Explain the setting of the video, focusing on the background '
    'elements like objects, location, weather, and time.',
    'Describe the overall environment in these frames, including '
    'details about objects, location, weather, and time.',
    'Given these equally spaced frames, provide a comprehensive '
    'background description, covering the objects, location, weather, '
    'and time.',
    'Imagine the environment from these frames and write a detailed '
    'description of the background, including objects, location, '
    'weather, and time.',
    'Based on these frames, describe the setting in detail, mentioning '
    'the objects present, the specific location, the weather '
    'conditions, and the time of day.',
    'Provide an elaborate background description based on these '
    'frames, covering all aspects of the environment such as objects, '
    'location, weather, and time.',
    'Using these frames as a reference, give a thorough description of '
    'the background, including details about the objects, location, '
    'weather, and time.',
]

MAIN_OBJECT_PROMPTS = [
    'Description of the main subject actions or status sequence. This '
    'suggests including the main subjects (person, object, animal, or '
    'none) and their attributes, their action, their position, and '
    'movements during the video frames.',
    "Describe the main subject's actions and movements.",
    'What is the main object doing in these frames?',
    "Summarize the primary subject's attributes and actions.",
    "Describe the main subject's position and movements.",
    'What actions does the main object take in these frames?',
    'Describe the main subject, including their attributes and '
    'movements throughout the video.',
    "Provide a detailed description of the main object's actions and "
    'positions in these frames.',
    "Summarize the main subject's actions, attributes, and movements "
    'during the video.',
    "Describe the primary subject's movements and actions in detail.",
    "What are the main object's attributes and how do they move "
    'throughout the video?',
    'Given these equally spaced frames, provide a comprehensive '
    'description of the main subject, including their attributes, '
    'actions, positions, and movements.',
    'Describe the primary object or subject in the video, detailing '
    'their attributes, actions, positions, and movements in these '
    'frames.',
    'Based on these frames, provide a detailed description of the main '
    'subject, including their attributes, actions, positions, and how '
    'they navigate through the video.',
    "Using these frames, describe the main subject's attributes, "
    'actions, and movements, detailing their positions and how they '
    'interact with the environment.',
    'Provide an elaborate description of the main object in the video, '
    'covering their attributes, actions, positions, and movements as '
    'shown in these frames.',
]

CAMERA_PROMPTS = [
    'Summary of the view shot, camera movement and changes in shooting '
    'angles in the sequence of video frames.',
    'Describe the camera movements in these frames.',
    'What are the camera angles and movements throughout the video?',
    'Summarize the camera actions and perspectives.',
    'Describe any camera zooms, pans, or angle changes.',
    'What camera movements are present in these frames?',
    "Describe the camera's movements, including pans, zooms, and angle "
    'changes in these frames.',
    'Summarize the camera actions and changes in shooting angles '
    'during the video.',
    "Provide a detailed description of the camera's movements and "
    'perspectives.',
    "Describe the camera's actions and how it follows the main subject.",
    'What are the camera movements and angle shifts in these frames?',
    'Given these equally spaced frames, provide a comprehensive '
    "description of the camera's movements, including any pans, zooms, "
    'and changes in shooting angles.',
    "Describe the camera's movements and angles in detail, explaining "
    'how it follows the main subject and changes perspectives.',
    'Based on these frames, provide a detailed description of the '
    "camera's actions, including any pans, zooms, angle shifts, and "
    'how it captures the scene.',
    "Using these frames, describe the camera's movements, including "
    'its tracking of the main subject, changes in angles, and any '
    'zooms or pans.',
    'Provide an elaborate description of the camera movements, '
    'covering pans, zooms, and changes in shooting angles as shown in '
    'these frames.',
]

SUBTASKS = {
    "vdc_short": SHORT_PROMPTS,
    "vdc_detailed": DETAILED_PROMPTS,
    "vdc_background": BACKGROUND_PROMPTS,
    "vdc_main_object": MAIN_OBJECT_PROMPTS,
    "vdc_camera": CAMERA_PROMPTS,
}


def gen_messages(caption: str, question: str) -> List[dict]:
    """The caption-QA generation payload (vdc/utils.py:201-217)."""
    user = (
        "Please provide accurate answers to questions related to the "
        "content based on a detailed description of a video or image:\n\n"
        f"detailed description: {caption}, question: {question}"
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
        "provide short but accurate answer.")
    return [{"role": "system", "content": GEN_SYSTEM},
            {"role": "user", "content": user}]


# Same Test_Videos/<video_name>.{mp4,MP4,mkv} lookup as videochatgpt
# (one shared implementation; reference vdc/utils.py:165-180 does the same
# probe via str.replace, which also mangles mid-name "mp4" substrings — the
# extension-append form is equivalent for real corpus names).
from videoitg_tpu_torch.eval.tasks.videochatgpt import doc_to_visual  # noqa: E402


def _doc_to_text(prompts: List[str]):
    def doc_to_text(doc):
        idx = zlib.crc32(str(doc.get("video_name", "")).encode())
        return prompts[idx % len(prompts)]

    return doc_to_text


def _qa_list(doc) -> List[dict]:
    qa = doc.get("qa_list") or []
    if isinstance(qa, str):
        try:
            qa = ast.literal_eval(qa)
        except Exception:
            qa = []
    return [q for q in qa if isinstance(q, dict) and "question" in q]


def process_results(doc, response: str) -> dict:
    """Two-phase llm_eval (vdc/utils.py:262-305): per qa pair, generate an
    answer from the predicted caption, then yes/no + 0-5 score it."""
    pred_caption = response if isinstance(response, str) else ""
    judge = get_judge()
    scores, accs = [], []
    for qa in _qa_list(doc):
        pred_answer = judge(gen_messages(pred_caption, qa["question"]),
                            max_tokens=256)
        review = judge(judge_messages(qa["question"],
                                      str(qa.get("answer", "")),
                                      pred_answer), max_tokens=256)
        # Reference llm_eval (utils.py:275-289): keep the judge's score RAW
        # (its own few-shot example is {'pred': 'yes', 'score': 4.8}, so
        # floats are normal) and count only pairs where BOTH keys parse —
        # malformed replies leave the denominator, they don't score 0.
        try:
            d = ast.literal_eval(review)
        except Exception:
            continue
        if not (isinstance(d, dict) and "pred" in d and "score" in d):
            continue
        try:
            scores.append(float(d["score"]))
        except Exception:
            continue
        accs.append(1.0 if d["pred"] == "yes" else 0.0)
    return {
        "video_name": doc["video_name"], "caption": doc.get("caption"),
        "pred": pred_caption,
        "score": (sum(scores) / len(scores)) if scores else 0.0,
        "acc": (sum(accs) / len(accs)) if accs else 0.0,
        "judge_model": judge.name,
    }


def _aggregate(prefix: str):
    def aggregate(records: List[dict]) -> Dict[str, float]:
        if not records:
            return {f"{prefix}_score": 0.0, f"{prefix}_acc": 0.0}

        def _mean(key):
            total = 0.0
            for r in records:  # utils.py:322-345: unparseable -> 0.0
                try:
                    total += float(r[key])
                except Exception:
                    pass
            return total / len(records)

        return {f"{prefix}_score": _mean("score"),
                f"{prefix}_acc": _mean("acc")}

    return aggregate


def _load(split: str):
    def load_docs(data_root: str, split_override: str = "") -> List[dict]:
        from videoitg_tpu_torch.eval.loaders import load_benchmark_docs

        return load_benchmark_docs("wchai/lmms_VDC_test", data_root,
                                   split_override or split)

    return load_docs


for _name in SUBTASKS:
    register_task(Task(
        name=_name,
        doc_to_visual=doc_to_visual,
        doc_to_text=_doc_to_text(SUBTASKS[_name]),
        process_results=process_results,
        aggregate=_aggregate(_name),
        # reference yamls all read test_split: test of the per-subtask
        # config (short_test.yaml etc.)
        load_docs=_load("test"),
        doc_id_key=None,
        primary_metric=f"{_name}_acc",
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0,
                           "do_sample": False},
    ))

register_group("vdc", list(SUBTASKS))
