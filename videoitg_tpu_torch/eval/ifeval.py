"""IFEval instruction-following checkers (parity: lmms_eval/tasks/
ifeval/instructions.py + instructions_registry.py + instructions_util.py
+ utils.py — Google's IFEval checker suite).

Every registered instruction id resolves to a checker whose
check_following logic matches the reference line-for-line in semantics.
At eval time the doc supplies every kwarg, so the reference's
random-default branches (used only for benchmark GENERATION) are
omitted; build_description still records the kwargs the checker needs.

Documented divergences (dependency-bound in this image):
* language detection (language:response_language + the two
  english_capital/english_lowercase checkers): the reference uses
  langdetect; here `detect_language` is a deterministic two-stage
  stand-in — Unicode-script ranges for non-Latin languages, then
  stopword voting over the LANGUAGE_CODES set for Latin ones.
  Undetectable text counts as following, exactly like the reference's
  LangDetectException path (instructions.py:170-175).
* count_sentences: the reference loads the nltk punkt model
  (instructions_util.py:1668-1677); punkt data is absent here, so the
  reference's OWN regex splitter (split_into_sentences,
  instructions_util.py:1609-1657) is used instead.
* CapitalWordFrequencyChecker tokenizes with a regex word tokenizer
  (nltk.word_tokenize also needs punkt); hyphenated words still count
  once (instructions.py:1432-1443).
"""

from __future__ import annotations

import collections
import json
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

# instructions_util.py:1564-1597.
LANGUAGE_CODES = {
    "en": "English", "es": "Spanish", "pt": "Portuguese", "ar": "Arabic",
    "hi": "Hindi", "fr": "French", "ru": "Russian", "de": "German",
    "ja": "Japanese", "it": "Italian", "bn": "Bengali", "uk": "Ukrainian",
    "th": "Thai", "ur": "Urdu", "ta": "Tamil", "te": "Telugu",
    "bg": "Bulgarian", "ko": "Korean", "pl": "Polish", "he": "Hebrew",
    "fa": "Persian", "vi": "Vietnamese", "ne": "Nepali", "sw": "Swahili",
    "kn": "Kannada", "mr": "Marathi", "gu": "Gujarati", "pa": "Punjabi",
    "ml": "Malayalam", "fi": "Finnish",
}

COMPARISON_RELATION = ("less than", "at least")

CONSTRAINED_RESPONSE_OPTIONS = (
    "My answer is yes.", "My answer is no.", "My answer is maybe.")

# --- language detection stand-in ------------------------------------------------

_SCRIPT_RANGES = [
    ("ar", (0x0600, 0x06FF)), ("he", (0x0590, 0x05FF)),
    ("hi", (0x0900, 0x097F)), ("bn", (0x0980, 0x09FF)),
    ("pa", (0x0A00, 0x0A7F)), ("gu", (0x0A80, 0x0AFF)),
    ("ta", (0x0B80, 0x0BFF)), ("te", (0x0C00, 0x0C7F)),
    ("kn", (0x0C80, 0x0CFF)), ("ml", (0x0D00, 0x0D7F)),
    ("th", (0x0E00, 0x0E7F)), ("ko", (0xAC00, 0xD7AF)),
    ("ja", (0x3040, 0x30FF)),
]
_CYRILLIC = (0x0400, 0x04FF)

_STOPWORDS = {
    "en": {"the", "and", "is", "of", "to", "in", "that", "you", "it",
           "for", "with", "are", "this", "have", "not", "was"},
    "es": {"el", "la", "de", "que", "los", "las", "una", "por", "con",
           "para", "es", "en", "del", "se"},
    "pt": {"o", "a", "de", "que", "os", "um", "uma", "para", "com",
           "nao", "não", "em", "do", "da", "é"},
    "fr": {"le", "la", "les", "de", "des", "et", "est", "une", "que",
           "pour", "dans", "vous", "je", "pas", "ce"},
    "de": {"der", "die", "das", "und", "ist", "nicht", "ein", "eine",
           "mit", "für", "auf", "den", "von", "zu", "sie"},
    "it": {"il", "la", "di", "che", "e", "un", "una", "per", "con",
           "non", "del", "della", "sono", "gli"},
    "vi": {"của", "và", "là", "không", "có", "được", "trong", "một",
           "này", "cho", "người", "những"},
    "pl": {"jest", "nie", "się", "w", "na", "i", "z", "do", "że", "to",
           "jak", "po"},
    "fi": {"ja", "on", "ei", "että", "se", "hän", "oli", "mutta",
           "joka", "niin", "kuin"},
    "sw": {"na", "ya", "wa", "kwa", "ni", "katika", "za", "hii", "kuwa",
           "watu"},
    "ne": {"र", "छ", "को", "मा", "का", "हो", "लाई", "गर्न"},
    "mr": {"आहे", "आणि", "च्या", "हे", "तो", "ती", "मध्ये"},
    "uk": {"і", "не", "на", "що", "це", "як", "до", "з", "у", "є"},
    "ru": {"и", "не", "на", "что", "это", "как", "в", "с", "по", "он"},
    "bg": {"и", "не", "на", "че", "това", "как", "в", "с", "да", "е"},
    "ur": {"ہے", "اور", "کے", "میں", "کی", "کا", "سے", "کو"},
    "fa": {"است", "و", "که", "در", "به", "از", "را", "با"},
}


def detect_language(text: str) -> Optional[str]:
    """Deterministic langdetect stand-in (divergence note above)."""
    counts: Dict[str, int] = collections.Counter()
    letters = 0
    for ch in text:
        cp = ord(ch)
        if not ch.isalpha():
            continue
        letters += 1
        for code, (lo, hi) in _SCRIPT_RANGES:
            if lo <= cp <= hi:
                counts[code] += 1
                break
        else:
            if _CYRILLIC[0] <= cp <= _CYRILLIC[1]:
                counts["_cyrillic"] += 1
            elif 0x4E00 <= cp <= 0x9FFF:
                counts["ja"] += 1  # kanji-only text: ja per CJK usage here
    if letters == 0:
        return None
    best, n = (counts.most_common(1) or [(None, 0)])[0]
    if best and n > letters * 0.3:
        if best != "_cyrillic":
            return best
        # Split Cyrillic languages (ru/uk/bg) by stopwords below.
    words = set(re.findall(r"[^\W\d_]+", text.lower(), re.UNICODE))
    votes = {code: len(words & sw) for code, sw in _STOPWORDS.items()}
    if best == "_cyrillic":
        votes = {c: votes.get(c, 0) for c in ("ru", "uk", "bg")}
    code, hits = max(votes.items(), key=lambda kv: kv[1])
    if hits == 0:
        return "en" if best is None else None
    return code


# --- text utilities -------------------------------------------------------------

_ALPHABETS = "([A-Za-z])"
_PREFIXES = "(Mr|St|Mrs|Ms|Dr)[.]"
_SUFFIXES = "(Inc|Ltd|Jr|Sr|Co)"
_STARTERS = (r"(Mr|Mrs|Ms|Dr|Prof|Capt|Cpt|Lt|He\s|She\s|It\s|They\s"
             r"|Their\s|Our\s|We\s|But\s|However\s|That\s|This\s"
             r"|Wherever)")
_ACRONYMS = "([A-Z][.][A-Z][.](?:[A-Z][.])?)"
_WEBSITES = "[.](com|net|org|io|gov|edu|me)"
_DIGITS = "([0-9])"
_MULTIPLE_DOTS = r"\.{2,}"


def split_into_sentences(text: str) -> List[str]:
    """instructions_util.py:1609-1657 — the reference's regex
    sentence splitter, verbatim semantics."""
    text = " " + text + "  "
    text = text.replace("\n", " ")
    text = re.sub(_PREFIXES, "\\1<prd>", text)
    text = re.sub(_WEBSITES, "<prd>\\1", text)
    text = re.sub(_DIGITS + "[.]" + _DIGITS, "\\1<prd>\\2", text)
    text = re.sub(_MULTIPLE_DOTS,
                  lambda m: "<prd>" * len(m.group(0)) + "<stop>", text)
    if "Ph.D" in text:
        text = text.replace("Ph.D.", "Ph<prd>D<prd>")
    text = re.sub(r"\s" + _ALPHABETS + "[.] ", " \\1<prd> ", text)
    text = re.sub(_ACRONYMS + " " + _STARTERS, "\\1<stop> \\2", text)
    text = re.sub(_ALPHABETS + "[.]" + _ALPHABETS + "[.]" + _ALPHABETS
                  + "[.]", "\\1<prd>\\2<prd>\\3<prd>", text)
    text = re.sub(_ALPHABETS + "[.]" + _ALPHABETS + "[.]",
                  "\\1<prd>\\2<prd>", text)
    text = re.sub(" " + _SUFFIXES + "[.] " + _STARTERS, " \\1<stop> \\2",
                  text)
    text = re.sub(" " + _SUFFIXES + "[.]", " \\1<prd>", text)
    text = re.sub(" " + _ALPHABETS + "[.]", " \\1<prd>", text)
    if "”" in text:
        text = text.replace(".”", "”.")
    if '"' in text:
        text = text.replace('."', '".')
    if "!" in text:
        text = text.replace('!"', '"!')
    if "?" in text:
        text = text.replace('?"', '"?')
    text = text.replace(".", ".<stop>")
    text = text.replace("?", "?<stop>")
    text = text.replace("!", "!<stop>")
    text = text.replace("<prd>", ".")
    sentences = [s.strip() for s in text.split("<stop>")]
    if sentences and not sentences[-1]:
        sentences = sentences[:-1]
    return sentences


def count_words(text: str) -> int:
    """instructions_util.py:1660-1665 (RegexpTokenizer(r"\\w+"))."""
    return len(re.findall(r"\w+", text))


def count_sentences(text: str) -> int:
    """punkt stand-in (divergence note above)."""
    return len(split_into_sentences(text))


def _word_tokenize(text: str) -> List[str]:
    """nltk.word_tokenize stand-in for CapitalWordFrequencyChecker:
    hyphenated words stay one token."""
    return re.findall(r"[A-Za-z0-9]+(?:[-'][A-Za-z0-9]+)*|[^\w\s]", text)


# --- checkers -------------------------------------------------------------------

class Instruction:
    def __init__(self, instruction_id):
        self.id = instruction_id

    def build_description(self, **kwargs):
        raise NotImplementedError

    def get_instruction_args(self):
        return None

    def check_following(self, value: str) -> bool:
        raise NotImplementedError


class ResponseLanguageChecker(Instruction):
    def build_description(self, *, language=None):
        self._language = language

    def check_following(self, value):
        """instructions.py:159-175 — undetectable counts as followed."""
        detected = detect_language(value)
        if detected is None:
            return True
        return detected == self._language


class NumberOfSentences(Instruction):
    def build_description(self, *, num_sentences=None, relation=None):
        self._num_sentences_threshold = num_sentences
        self._comparison_relation = relation

    def check_following(self, value):
        num_sentences = count_sentences(value)
        if self._comparison_relation == COMPARISON_RELATION[0]:
            return num_sentences < self._num_sentences_threshold
        return num_sentences >= self._num_sentences_threshold


class PlaceholderChecker(Instruction):
    def build_description(self, *, num_placeholders=None):
        self._num_placeholders = num_placeholders

    def check_following(self, value):
        return len(re.findall(r"\[.*?\]", value)) >= self._num_placeholders


class BulletListChecker(Instruction):
    def build_description(self, *, num_bullets=None):
        self._num_bullets = num_bullets

    def check_following(self, value):
        """instructions.py:314-328."""
        bullets = re.findall(r"^\s*\*[^\*].*$", value, flags=re.MULTILINE)
        bullets2 = re.findall(r"^\s*-.*$", value, flags=re.MULTILINE)
        return len(bullets) + len(bullets2) == self._num_bullets


class ConstrainedResponseChecker(Instruction):
    def build_description(self):
        self._constrained_responses = CONSTRAINED_RESPONSE_OPTIONS

    def check_following(self, value):
        value = value.strip()
        return any(option in value
                   for option in self._constrained_responses)


class ConstrainedStartChecker(Instruction):
    def build_description(self, *, starter=None):
        self._starter = starter.strip() if isinstance(starter, str) \
            else starter

    def check_following(self, value):
        pattern = r"^\s*" + self._starter + r".*$"
        return bool(re.search(pattern, value, flags=re.MULTILINE))


class HighlightSectionChecker(Instruction):
    def build_description(self, *, num_highlights=None):
        self._num_highlights = num_highlights

    def check_following(self, value):
        """instructions.py:437-458."""
        num = 0
        for h in re.findall(r"\*[^\n\*]*\*", value):
            if h.strip("*").strip():
                num += 1
        for h in re.findall(r"\*\*[^\n\*]*\*\*", value):
            if h.removeprefix("**").removesuffix("**").strip():
                num += 1
        return num >= self._num_highlights


class SectionChecker(Instruction):
    def build_description(self, *, section_spliter=None,
                          num_sections=None):
        self._section_spliter = section_spliter.strip() \
            if isinstance(section_spliter, str) else section_spliter
        self._num_sections = num_sections

    def check_following(self, value):
        pattern = r"\s?" + self._section_spliter + r"\s?\d+\s?"
        sections = re.split(pattern, value)
        return len(sections) - 1 >= self._num_sections


class ParagraphChecker(Instruction):
    def build_description(self, *, num_paragraphs=None):
        self._num_paragraphs = num_paragraphs

    def check_following(self, value):
        """instructions.py:552-573."""
        paragraphs = re.split(r"\s?\*\*\*\s?", value)
        num_paragraphs = len(paragraphs)
        for index, paragraph in enumerate(paragraphs):
            if not paragraph.strip():
                if index == 0 or index == len(paragraphs) - 1:
                    num_paragraphs -= 1
                else:
                    return False
        return num_paragraphs == self._num_paragraphs


class PostscriptChecker(Instruction):
    def build_description(self, *, postscript_marker=None):
        self._postscript_marker = postscript_marker.strip() \
            if isinstance(postscript_marker, str) else postscript_marker

    def check_following(self, value):
        """instructions.py:605-624."""
        value = value.lower()
        if self._postscript_marker == "P.P.S":
            pattern = r"\s*p\.\s?p\.\s?s.*$"
        elif self._postscript_marker == "P.S.":
            pattern = r"\s*p\.\s?s\..*$"
        else:
            pattern = r"\s*" + self._postscript_marker.lower() + r".*$"
        return bool(re.findall(pattern, value, flags=re.MULTILINE))


class KeywordChecker(Instruction):
    def build_description(self, *, keywords=None):
        self._keywords = sorted(keywords)

    def check_following(self, value):
        for keyword in self._keywords:
            if not re.search(keyword, value, flags=re.IGNORECASE):
                return False
        return True


class KeywordFrequencyChecker(Instruction):
    def build_description(self, *, keyword=None, frequency=None,
                          relation=None):
        self._keyword = keyword.strip()
        self._frequency = frequency
        self._comparison_relation = relation

    def check_following(self, value):
        actual = len(re.findall(self._keyword, value,
                                flags=re.IGNORECASE))
        if self._comparison_relation == COMPARISON_RELATION[0]:
            return actual < self._frequency
        return actual >= self._frequency


class NumberOfWords(Instruction):
    def build_description(self, *, num_words=None, relation=None):
        self._num_words = num_words
        self._comparison_relation = relation

    def check_following(self, value):
        num_words = count_words(value)
        if self._comparison_relation == COMPARISON_RELATION[0]:
            return num_words < self._num_words
        return num_words >= self._num_words


class JsonFormat(Instruction):
    def build_description(self):
        pass

    def check_following(self, value):
        """instructions.py:858-864."""
        value = (value.strip().removeprefix("```json")
                 .removeprefix("```Json").removeprefix("```JSON")
                 .removeprefix("```").removesuffix("```").strip())
        try:
            json.loads(value)
        except ValueError:
            return False
        return True


class ParagraphFirstWordCheck(Instruction):
    def build_description(self, num_paragraphs=None, nth_paragraph=None,
                          first_word=None):
        self._num_paragraphs = num_paragraphs
        self._nth_paragraph = nth_paragraph
        self._first_word = first_word.lower()

    def check_following(self, value):
        """instructions.py:922-964."""
        paragraphs = re.split(r"\n\n", value)
        num_paragraphs = len(paragraphs)
        for paragraph in paragraphs:
            if not paragraph.strip():
                num_paragraphs -= 1
        if self._nth_paragraph <= num_paragraphs:
            paragraph = paragraphs[self._nth_paragraph - 1].strip()
            if not paragraph:
                return False
        else:
            return False
        first_word = ""
        punctuation = {".", ",", "?", "!", "'", '"'}
        word = paragraph.split()[0].strip()
        word = word.lstrip("'").lstrip('"')
        for letter in word:
            if letter in punctuation:
                break
            first_word += letter.lower()
        return (num_paragraphs == self._num_paragraphs
                and first_word == self._first_word)


class ForbiddenWords(Instruction):
    def build_description(self, forbidden_words=None):
        self._forbidden_words = sorted(set(forbidden_words))

    def check_following(self, value):
        for word in self._forbidden_words:
            if re.search(r"\b" + word + r"\b", value,
                         flags=re.IGNORECASE):
                return False
        return True


class TwoResponsesChecker(Instruction):
    def build_description(self):
        pass

    def check_following(self, value):
        """instructions.py:1134-1151."""
        valid_responses = []
        responses = value.split("******")
        for index, response in enumerate(responses):
            if not response.strip():
                if index != 0 and index != len(responses) - 1:
                    return False
            else:
                valid_responses.append(response)
        return (len(valid_responses) == 2
                and valid_responses[0].strip()
                != valid_responses[1].strip())


class RepeatPromptThenAnswer(Instruction):
    def build_description(self, *, prompt_to_repeat=None):
        if not prompt_to_repeat:
            raise ValueError("prompt_to_repeat must be set.")
        self._prompt_to_repeat = prompt_to_repeat

    def get_instruction_args(self):
        return {"prompt_to_repeat": self._prompt_to_repeat}

    def check_following(self, value):
        return value.strip().lower().startswith(
            self._prompt_to_repeat.strip().lower())


class EndChecker(Instruction):
    def build_description(self, *, end_phrase=None):
        self._end_phrase = end_phrase.strip() \
            if isinstance(end_phrase, str) else end_phrase

    def check_following(self, value):
        value = value.strip().strip('"').lower()
        self._end_phrase = self._end_phrase.strip().lower()
        return value.endswith(self._end_phrase)


class TitleChecker(Instruction):
    def build_description(self):
        pass

    def check_following(self, value):
        for title in re.findall(r"<<[^\n]+>>", value):
            if title.lstrip("<").rstrip(">").strip():
                return True
        return False


class LetterFrequencyChecker(Instruction):
    def build_description(self, *, letter=None, let_frequency=None,
                          let_relation=None):
        self._letter = letter.strip().lower()
        self._frequency = let_frequency
        self._comparison_relation = let_relation

    def check_following(self, value):
        letters = collections.Counter(value.lower())
        if self._comparison_relation == COMPARISON_RELATION[0]:
            return letters[self._letter] < self._frequency
        return letters[self._letter] >= self._frequency


class CapitalLettersEnglishChecker(Instruction):
    def build_description(self):
        pass

    def check_following(self, value):
        # Reference instructions.py:1334 `value.isupper() and
        # langdetect.detect(value) == "en"` SHORT-CIRCUITS: when the case
        # predicate fails, detect() never runs and the result is False.
        # Only case-conforming undetectable text reaches the
        # LangDetectException -> True arm, which the stand-in's None
        # reproduces exactly.
        return value.isupper() and detect_language(value) in (None, "en")


class LowercaseLettersEnglishChecker(Instruction):
    def build_description(self):
        pass

    def check_following(self, value):
        # islower() short-circuits before detection (see above)
        return value.islower() and detect_language(value) in (None, "en")


class CommaChecker(Instruction):
    def build_description(self):
        pass

    def check_following(self, value):
        return not re.search(r"\,", value)


class CapitalWordFrequencyChecker(Instruction):
    def build_description(self, capital_frequency=None,
                          capital_relation=None):
        self._frequency = capital_frequency
        self._comparison_relation = capital_relation

    def check_following(self, value):
        capital_words = len([w for w in _word_tokenize(value)
                             if w.isupper()])
        if self._comparison_relation == COMPARISON_RELATION[0]:
            return capital_words < self._frequency
        return capital_words >= self._frequency


class QuotationChecker(Instruction):
    def build_description(self):
        pass

    def check_following(self, value):
        value = value.strip()
        return len(value) > 1 and value[0] == '"' and value[-1] == '"'


# instructions_registry.py:40-70.
INSTRUCTION_DICT = {
    "keywords:existence": KeywordChecker,
    "keywords:frequency": KeywordFrequencyChecker,
    "keywords:forbidden_words": ForbiddenWords,
    "keywords:letter_frequency": LetterFrequencyChecker,
    "language:response_language": ResponseLanguageChecker,
    "length_constraints:number_sentences": NumberOfSentences,
    "length_constraints:number_paragraphs": ParagraphChecker,
    "length_constraints:number_words": NumberOfWords,
    "length_constraints:nth_paragraph_first_word":
        ParagraphFirstWordCheck,
    "detectable_content:number_placeholders": PlaceholderChecker,
    "detectable_content:postscript": PostscriptChecker,
    "detectable_format:number_bullet_lists": BulletListChecker,
    "detectable_format:constrained_response": ConstrainedResponseChecker,
    "detectable_format:number_highlighted_sections":
        HighlightSectionChecker,
    "detectable_format:multiple_sections": SectionChecker,
    "detectable_format:json_format": JsonFormat,
    "detectable_format:title": TitleChecker,
    "combination:two_responses": TwoResponsesChecker,
    "combination:repeat_prompt": RepeatPromptThenAnswer,
    "startend:end_checker": EndChecker,
    "change_case:capital_word_frequency": CapitalWordFrequencyChecker,
    "change_case:english_capital": CapitalLettersEnglishChecker,
    "change_case:english_lowercase": LowercaseLettersEnglishChecker,
    "punctuation:no_comma": CommaChecker,
    "startend:quotation": QuotationChecker,
    "multi-turn:constrained_start": ConstrainedStartChecker,
}


# --- strict/loose evaluation (utils.py) ------------------------------------------

@dataclass
class InputExample:
    key: int
    instruction_id_list: List[str]
    prompt: str
    kwargs: List[Dict[str, Optional[Union[str, int]]]]


def _check_one(instruction_id: str, kwargs: dict, prompt: str,
               response: str) -> bool:
    instruction = INSTRUCTION_DICT[instruction_id](instruction_id)
    kwargs = {k: v for k, v in kwargs.items() if v}
    instruction.build_description(**kwargs)
    args = instruction.get_instruction_args()
    if args and "prompt" in args:
        instruction.build_description(prompt=prompt)
    return bool(response.strip()
                and instruction.check_following(response))


def test_instruction_following_strict(inp: InputExample,
                                      response: str) -> List[bool]:
    """utils.py:25-55."""
    return [_check_one(instruction_id, inp.kwargs[i], inp.prompt,
                       response)
            for i, instruction_id in enumerate(inp.instruction_id_list)]


def test_instruction_following_loose(inp: InputExample,
                                     response: str) -> List[bool]:
    """utils.py:58-110 — try 8 relaxed variants of the response."""
    r = response.split("\n")
    response_remove_first = "\n".join(r[1:]).strip()
    response_remove_last = "\n".join(r[:-1]).strip()
    response_remove_both = "\n".join(r[1:-1]).strip()
    all_responses = [
        response,
        response.replace("*", ""),
        response_remove_first,
        response_remove_last,
        response_remove_both,
        response_remove_first.replace("*", ""),
        response_remove_last.replace("*", ""),
        response_remove_both.replace("*", ""),
    ]
    results = []
    for i, instruction_id in enumerate(inp.instruction_id_list):
        following = False
        for candidate in all_responses:
            if candidate.strip() and _check_one(
                    instruction_id, inp.kwargs[i], inp.prompt, candidate):
                following = True
                break
        results.append(following)
    return results
