"""Built-in English grapheme→IPA fallback (no espeak-ng needed).

The real checkpoint text contract is espeak-ng IPA (reference
``lemas_tts/infer/text_norm/tokenizer.py:26-74``, ``frontend.py:184-223``);
in hermetic environments the previous fallback degraded English to CHAR
tokens — maximizing the distance to what checkpoints were trained on. This
module shrinks that gap: a vendored exception
lexicon of high-frequency words plus a context-sensitive letter-to-sound
rule engine (the classic NRL text-to-phoneme rule formalism — Elovitz et
al. 1976, a public-domain US government report — re-targeted at the espeak
en-us IPA inventory) produce ``|``-separated IPA phone streams in the same
separator grammar as ``text/tokenizer.py`` (word sep ``_``, no stress marks
— matching our ``EspeakBackend(with_stress=False)`` configuration).

This is an APPROXIMATION of espeak's output, not a clone: it exists so a
hermetic deployment emits mostly-in-vocab IPA tokens instead of letters.
(Copy of ``lemas_tts_tpu/text/en_ipa.py``.)

Phone inventory (espeak en-us, unstressed): consonants
b d dʒ ð f ɡ h j k l m n ŋ p ɹ s ʃ t tʃ θ v w z ʒ; vowels
iː ɪ eɪ ɛ æ ɑː ɔː oʊ ʊ uː ʌ ə ɚ ɜː aɪ aʊ ɔɪ.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

# ---------------------------------------------------------------- lexicon
# High-frequency words + common irregulars whose pronunciation the rules
# can't derive. Space-separated phones, one entry per line-ish for diffs.
_LEX_RAW: Dict[str, str] = {
    # articles / pronouns / function words
    "a": "ə", "an": "ə n", "the": "ð ə", "of": "ʌ v", "to": "t uː",
    "and": "æ n d", "in": "ɪ n", "is": "ɪ z", "it": "ɪ t", "you": "j uː",
    "that": "ð æ t", "he": "h iː", "was": "w ʌ z", "for": "f ɔː ɹ",
    "on": "ɑː n", "are": "ɑː ɹ", "as": "æ z", "with": "w ɪ ð",
    "his": "h ɪ z", "they": "ð eɪ", "i": "aɪ", "at": "æ t", "be": "b iː",
    "this": "ð ɪ s", "have": "h æ v", "from": "f ɹ ʌ m", "or": "ɔː ɹ",
    "had": "h æ d", "by": "b aɪ", "word": "w ɜː d", "but": "b ʌ t",
    "not": "n ɑː t", "what": "w ʌ t", "all": "ɔː l", "were": "w ɜː",
    "we": "w iː", "when": "w ɛ n", "your": "j ɔː ɹ", "can": "k æ n",
    "said": "s ɛ d", "there": "ð ɛ ɹ", "use": "j uː z", "each": "iː tʃ",
    "which": "w ɪ tʃ", "she": "ʃ iː", "do": "d uː", "how": "h aʊ",
    "their": "ð ɛ ɹ", "if": "ɪ f", "will": "w ɪ l", "up": "ʌ p",
    "other": "ʌ ð ɚ", "about": "ə b aʊ t", "out": "aʊ t",
    "many": "m ɛ n i", "then": "ð ɛ n", "them": "ð ɛ m",
    "these": "ð iː z", "so": "s oʊ", "some": "s ʌ m", "her": "h ɜː",
    "would": "w ʊ d", "make": "m eɪ k", "like": "l aɪ k",
    "him": "h ɪ m", "into": "ɪ n t uː", "time": "t aɪ m",
    "has": "h æ z", "look": "l ʊ k", "more": "m ɔː ɹ",
    "write": "ɹ aɪ t", "go": "ɡ oʊ", "see": "s iː",
    "no": "n oʊ", "way": "w eɪ", "could": "k ʊ d", "my": "m aɪ",
    "than": "ð æ n", "first": "f ɜː s t", "been": "b ɪ n",
    "who": "h uː", "its": "ɪ t s", "now": "n aʊ", "people": "p iː p əl",
    "made": "m eɪ d", "over": "oʊ v ɚ", "did": "d ɪ d",
    "down": "d aʊ n", "only": "oʊ n l i", "way": "w eɪ",
    "find": "f aɪ n d", "any": "ɛ n i", "new": "n uː",
    "work": "w ɜː k", "part": "p ɑː ɹ t", "take": "t eɪ k",
    "get": "ɡ ɛ t", "place": "p l eɪ s", "live": "l ɪ v",
    "where": "w ɛ ɹ", "after": "æ f t ɚ", "back": "b æ k",
    "little": "l ɪ t əl", "round": "ɹ aʊ n d", "man": "m æ n",
    "year": "j ɪ ɹ", "came": "k eɪ m", "show": "ʃ oʊ",
    "every": "ɛ v ɹ i", "good": "ɡ ʊ d", "me": "m iː",
    "give": "ɡ ɪ v", "our": "aʊ ɚ", "under": "ʌ n d ɚ",
    "very": "v ɛ ɹ i", "through": "θ ɹ uː", "just": "dʒ ʌ s t",
    "great": "ɡ ɹ eɪ t", "say": "s eɪ", "low": "l oʊ",
    "cause": "k ɔː z", "much": "m ʌ tʃ", "before": "b ɪ f ɔː ɹ",
    "move": "m uː v", "right": "ɹ aɪ t", "too": "t uː",
    "does": "d ʌ z", "another": "ə n ʌ ð ɚ", "even": "iː v ə n",
    "because": "b ɪ k ʌ z", "any": "ɛ n i", "here": "h ɪ ɹ",
    "why": "w aɪ", "again": "ə ɡ ɛ n", "off": "ɔː f",
    "went": "w ɛ n t", "old": "oʊ l d", "come": "k ʌ m",
    "two": "t uː", "one": "w ʌ n", "once": "w ʌ n s",
    "four": "f ɔː ɹ", "eight": "eɪ t", "busy": "b ɪ z i",
    "buy": "b aɪ", "eye": "aɪ", "lose": "l uː z", "whose": "h uː z",
    "done": "d ʌ n", "gone": "ɡ ɔː n", "none": "n ʌ n",
    "above": "ə b ʌ v", "love": "l ʌ v", "give": "ɡ ɪ v",
    "most": "m oʊ s t", "both": "b oʊ θ", "front": "f ɹ ʌ n t",
    "month": "m ʌ n θ", "among": "ə m ʌ ŋ", "money": "m ʌ n i",
    "nothing": "n ʌ θ ɪ ŋ", "something": "s ʌ m θ ɪ ŋ",
    "water": "w ɔː t ɚ", "woman": "w ʊ m ə n", "women": "w ɪ m ɪ n",
    "world": "w ɜː l d", "know": "n oʊ", "knew": "n uː",
    "always": "ɔː l w eɪ z", "also": "ɔː l s oʊ",
    "together": "t ə ɡ ɛ ð ɚ", "mother": "m ʌ ð ɚ",
    "father": "f ɑː ð ɚ", "brother": "b ɹ ʌ ð ɚ",
    "friend": "f ɹ ɛ n d", "answer": "æ n s ɚ",
    "often": "ɔː f ə n", "island": "aɪ l ə n d",
    "hour": "aʊ ɚ", "honest": "ɑː n ə s t", "honor": "ɑː n ɚ",
    "early": "ɜː l i", "earth": "ɜː θ", "heard": "h ɜː d",
    "learn": "l ɜː n", "heart": "h ɑː ɹ t", "head": "h ɛ d",
    "dead": "d ɛ d", "bread": "b ɹ ɛ d", "ready": "ɹ ɛ d i",
    "read": "ɹ iː d", "great": "ɡ ɹ eɪ t", "break": "b ɹ eɪ k",
    "steak": "s t eɪ k", "eyes": "aɪ z", "idea": "aɪ d iː ə",
    "area": "ɛ ɹ i ə", "usually": "j uː ʒ u ə l i",
    "sure": "ʃ ʊ ɹ", "sugar": "ʃ ʊ ɡ ɚ", "ocean": "oʊ ʃ ə n",
    "special": "s p ɛ ʃ əl", "machine": "m ə ʃ iː n",
    "question": "k w ɛ s tʃ ə n", "nature": "n eɪ tʃ ɚ",
    "picture": "p ɪ k tʃ ɚ", "future": "f j uː tʃ ɚ",
    "measure": "m ɛ ʒ ɚ", "pleasure": "p l ɛ ʒ ɚ",
    "usual": "j uː ʒ u əl", "vision": "v ɪ ʒ ə n",
    "decision": "d ɪ s ɪ ʒ ə n", "television": "t ɛ l ə v ɪ ʒ ə n",
    "beautiful": "b j uː t ɪ f əl", "language": "l æ ŋ ɡ w ɪ dʒ",
    "against": "ə ɡ ɛ n s t", "though": "ð oʊ",
    "thought": "θ ɔː t", "through": "θ ɹ uː", "enough": "ɪ n ʌ f",
    "tough": "t ʌ f", "rough": "ɹ ʌ f", "laugh": "l æ f",
    "cough": "k ɔː f", "daughter": "d ɔː t ɚ",
    "caught": "k ɔː t", "taught": "t ɔː t", "bought": "b ɔː t",
    "brought": "b ɹ ɔː t", "night": "n aɪ t", "light": "l aɪ t",
    "might": "m aɪ t", "high": "h aɪ", "eight": "eɪ t",
    "weight": "w eɪ t", "height": "h aɪ t", "neighbor": "n eɪ b ɚ",
    "straight": "s t ɹ eɪ t", "half": "h æ f", "calf": "k æ f",
    "walk": "w ɔː k", "talk": "t ɔː k", "could": "k ʊ d",
    "should": "ʃ ʊ d", "would": "w ʊ d", "group": "ɡ ɹ uː p",
    "soup": "s uː p", "you're": "j ʊ ɹ", "don't": "d oʊ n t",
    "won't": "w oʊ n t", "can't": "k æ n t", "i'm": "aɪ m",
    "it's": "ɪ t s", "that's": "ð æ t s", "there's": "ð ɛ ɹ z",
    "he's": "h iː z", "she's": "ʃ iː z", "let's": "l ɛ t s",
    "i'll": "aɪ l", "we'll": "w iː l", "you'll": "j uː l",
    "i've": "aɪ v", "we've": "w iː v", "they're": "ð ɛ ɹ",
    "isn't": "ɪ z ə n t", "wasn't": "w ʌ z ə n t",
    "doesn't": "d ʌ z ə n t", "didn't": "d ɪ d ə n t",
    "couldn't": "k ʊ d ə n t", "wouldn't": "w ʊ d ə n t",
    # numbers (replace_numbers_with_words output feeds these)
    "zero": "z ɪ ɹ oʊ", "three": "θ ɹ iː", "five": "f aɪ v",
    "six": "s ɪ k s", "seven": "s ɛ v ə n", "nine": "n aɪ n",
    "ten": "t ɛ n", "eleven": "ɪ l ɛ v ə n", "twelve": "t w ɛ l v",
    "thirteen": "θ ɜː t iː n", "fifteen": "f ɪ f t iː n",
    "twenty": "t w ɛ n t i", "thirty": "θ ɜː t i",
    "forty": "f ɔː ɹ t i", "fifty": "f ɪ f t i",
    "eighty": "eɪ t i", "hundred": "h ʌ n d ɹ ə d",
    "thousand": "θ aʊ z ə n d", "million": "m ɪ l j ə n",
    "billion": "b ɪ l j ə n", "point": "p ɔɪ n t",
    "first": "f ɜː s t", "second": "s ɛ k ə n d",
    "third": "θ ɜː d", "fourth": "f ɔː ɹ θ", "fifth": "f ɪ f θ",
    "eighth": "eɪ t θ", "ninth": "n aɪ n θ", "twelfth": "t w ɛ l f θ",
    # common content words with tricky vowels
    "quick": "k w ɪ k", "brown": "b ɹ aʊ n", "jumps": "dʒ ʌ m p s",
    "lazy": "l eɪ z i", "dogs": "d ɔː ɡ z", "dog": "d ɔː ɡ",
    "fox": "f ɑː k s", "hello": "h ə l oʊ", "general": "dʒ ɛ n ɚ əl",
    "there": "ð ɛ ɹ", "chapter": "tʃ æ p t ɚ", "begins": "b ɪ ɡ ɪ n z",
    "page": "p eɪ dʒ", "pages": "p eɪ dʒ ɪ z",
    "one": "w ʌ n", "two": "t uː", "world": "w ɜː l d",
    "today": "t ə d eɪ", "tomorrow": "t ə m ɑː ɹ oʊ",
    "yesterday": "j ɛ s t ɚ d eɪ", "morning": "m ɔː ɹ n ɪ ŋ",
    "evening": "iː v n ɪ ŋ", "minute": "m ɪ n ɪ t",
    "minutes": "m ɪ n ɪ t s", "business": "b ɪ z n ə s",
    "company": "k ʌ m p ə n i", "country": "k ʌ n t ɹ i",
    "countries": "k ʌ n t ɹ i z", "family": "f æ m ə l i",
    "different": "d ɪ f ɹ ə n t", "important": "ɪ m p ɔː ɹ t ə n t",
    "example": "ɪ ɡ z æ m p əl", "experience": "ɪ k s p ɪ ɹ i ə n s",
    "government": "ɡ ʌ v ɚ n m ə n t", "information": "ɪ n f ɚ m eɪ ʃ ə n",
    "science": "s aɪ ə n s", "service": "s ɜː v ɪ s",
    "system": "s ɪ s t ə m", "percent": "p ɚ s ɛ n t",
    "dollars": "d ɑː l ɚ z", "dollar": "d ɑː l ɚ",
    "guest": "ɡ ɛ s t", "guide": "ɡ aɪ d", "guitar": "ɡ ɪ t ɑː ɹ",
    "building": "b ɪ l d ɪ ŋ", "build": "b ɪ l d",
    "guess": "ɡ ɛ s", "does": "d ʌ z", "shoes": "ʃ uː z",
    "iron": "aɪ ɚ n", "listen": "l ɪ s ə n", "castle": "k æ s əl",
    "whistle": "w ɪ s əl", "climb": "k l aɪ m", "comb": "k oʊ m",
    "lamb": "l æ m", "thumb": "θ ʌ m", "debt": "d ɛ t",
    "doubt": "d aʊ t", "receipt": "ɹ ɪ s iː t",
    "stomach": "s t ʌ m ə k", "choir": "k w aɪ ɚ",
    "chorus": "k ɔː ɹ ə s", "chemistry": "k ɛ m ɪ s t ɹ i",
    "character": "k ɛ ɹ ə k t ɚ", "school": "s k uː l",
    "echo": "ɛ k oʊ", "ache": "eɪ k", "anchor": "æ ŋ k ɚ",
    "colonel": "k ɜː n əl", "wednesday": "w ɛ n z d eɪ",
    "february": "f ɛ b j u ɛ ɹ i", "library": "l aɪ b ɹ ɛ ɹ i",
    "people": "p iː p əl", "police": "p ə l iː s",
    "pretty": "p ɹ ɪ t i", "juice": "dʒ uː s", "fruit": "f ɹ uː t",
    "suit": "s uː t", "believe": "b ɪ l iː v", "piece": "p iː s",
    "field": "f iː l d", "friend": "f ɹ ɛ n d",
    "says": "s ɛ z", "southern": "s ʌ ð ɚ n",
    "touch": "t ʌ tʃ", "young": "j ʌ ŋ", "double": "d ʌ b əl",
    "trouble": "t ɹ ʌ b əl", "couple": "k ʌ p əl",
    "cousin": "k ʌ z ə n", "blood": "b l ʌ d", "flood": "f l ʌ d",
    "foot": "f ʊ t", "book": "b ʊ k", "took": "t ʊ k",
    "put": "p ʊ t", "push": "p ʊ ʃ", "pull": "p ʊ l",
    "full": "f ʊ l", "wolf": "w ʊ l f", "kenobi": "k ə n oʊ b i",
    "city": "s ɪ t i", "cities": "s ɪ t i z", "house": "h aʊ s",
    "houses": "h aʊ z ɪ z", "housing": "h aʊ z ɪ ŋ",
    "very": "v ɛ ɹ i", "every": "ɛ v ɹ i", "everything": "ɛ v ɹ i θ ɪ ŋ",
    "everyone": "ɛ v ɹ i w ʌ n", "anyone": "ɛ n i w ʌ n",
    "anything": "ɛ n i θ ɪ ŋ", "someone": "s ʌ m w ʌ n",
    "sometimes": "s ʌ m t aɪ m z", "however": "h aʊ ɛ v ɚ",
    "during": "d ʊ ɹ ɪ ŋ", "being": "b iː ɪ ŋ", "doing": "d uː ɪ ŋ",
    "going": "ɡ oʊ ɪ ŋ", "getting": "ɡ ɛ t ɪ ŋ",
}

_LEXICON: Dict[str, List[str]] = {w: p.split() for w, p in _LEX_RAW.items()}

# --------------------------------------------------- letter-to-sound rules
# NRL-formalism contexts (Elovitz et al. 1976, public domain; rules below
# re-derived for IPA):  # = 1+ vowels · : = 0+ consonants · ^ = 1 consonant
# · . = voiced consonant · + = front vowel (e/i/y) · % = suffix
# (e/er/es/ed/ing/ely) · ' ' = word boundary. Rules per leading letter are
# tried in order; first full match wins and consumes len(match) letters.
_VOWELS = "aeiouy"
_CONS = "bcdfghjklmnpqrstvwxz"
_VOICED = "bdvgjlmnrwz"
_FRONT = "eiy"

# (left, match, right, phones) — phones is a space-separated IPA string.
_RULES_RAW: Dict[str, List] = {
    "a": [
        (" ", "a", " ", "ə"),
        ("", "are", " ", "ɑː ɹ"),
        (" ", "ar", "o", "ə ɹ"),
        ("", "ar", "#", "ɛ ɹ"),
        ("", "air", "", "ɛ ɹ"),
        ("", "ar", "", "ɑː ɹ"),
        ("", "augh", "", "ɔː"),
        ("", "aw", "", "ɔː"),
        ("", "au", "", "ɔː"),
        (" :", "any", "", "ɛ n i"),
        ("", "alk", "", "ɔː k"),
        ("#:", "ally", "", "ə l i"),
        (" ", "al", "#", "ə l"),
        ("#:", "al", " ", "əl"),   # national, animal
        ("#:", "als", " ", "əl z"),
        ("", "al", "^", "ɔː l"),
        (" :", "able", "", "eɪ b əl"),
        ("", "able", "", "ə b əl"),
        ("", "ange", "", "eɪ n dʒ"),
        ("", "a", "tio", "eɪ"),  # nation, station, education
        ("", "ay", "", "eɪ"),
        ("", "ai", "", "eɪ"),
        ("#:", "ag", "e", "ɪ dʒ"),
        ("", "a", "^+:#", "æ"),
        (" :", "a", "^+ ", "eɪ"),
        ("", "a", "^%", "eɪ"),
        ("", "a", "^e ", "eɪ"),
        ("", "a", "", "æ"),
    ],
    "b": [
        ("", "bb", "", "b"),
        (" ", "b", " ", "b iː"),
        ("", "b", "t ", ""),  # debt/doubt (lexicon covers most)
        ("m", "b", " ", ""),  # lamb, climb
        ("", "b", "", "b"),
    ],
    "c": [
        ("", "ch", "^", "k"),  # christmas, school-ish clusters
        (" s", "ci", "#", "s aɪ"),
        ("", "ci", "a", "ʃ"),
        ("", "ci", "o", "ʃ"),
        ("", "ci", "en", "ʃ"),
        ("", "ch", "", "tʃ"),
        ("", "ck", "", "k"),
        ("", "c", "+", "s"),
        ("", "cc", "+", "k s"),
        ("", "cc", "", "k"),
        ("", "c", "", "k"),
    ],
    "d": [
        ("", "dd", "", "d"),
        ("#:", "ded", " ", "d ɪ d"),
        (".e", "d", " ", "d"),  # voiced + ed → d (loved)
        ("#:^e", "d", " ", "t"),  # unvoiced + ed → t (walked)
        ("", "d", "", "d"),
    ],
    "e": [
        ("#:", "e", " ", ""),  # silent final e
        ("':^", "e", " ", ""),
        (" :", "e", " ", "iː"),
        ("#", "ed", " ", "d"),  # played
        ("#:^", "e", "d ", ""),  # silent e in C+ed: walked, loved, watched
        ("", "ear", "^", "ɜː"),  # early, learn, earn
        ("", "eer", "", "ɪ ɹ"),
        ("", "ere", " ", "ɪ ɹ"),
        ("", "er", "#", "ɛ ɹ"),
        ("#:", "er", " ", "ɚ"),
        ("#:", "er", "", "ɚ"),
        ("", "er", "", "ɜː"),
        (" ", "even", "", "iː v ə n"),
        ("#:", "e", "w", ""),
        ("t", "ew", "", "uː"),
        ("s", "ew", "", "uː"),
        ("r", "ew", "", "uː"),
        ("d", "ew", "", "uː"),
        ("l", "ew", "", "uː"),
        ("z", "ew", "", "uː"),
        ("n", "ew", "", "uː"),
        ("j", "ew", "", "uː"),
        ("th", "ew", "", "uː"),
        ("ch", "ew", "", "uː"),
        ("sh", "ew", "", "uː"),
        ("", "ew", "", "j uː"),
        ("", "e", "o", "iː"),
        ("#:s", "es", " ", "ɪ z"),  # houses
        ("#:c", "es", " ", "ɪ z"),
        ("#:g", "es", " ", "ɪ z"),
        ("#:z", "es", " ", "ɪ z"),
        ("#:x", "es", " ", "ɪ z"),
        ("#:j", "es", " ", "ɪ z"),
        ("#:ch", "es", " ", "ɪ z"),
        ("#:sh", "es", " ", "ɪ z"),
        ("#:", "e", "s ", ""),
        ("#:", "ely", " ", "l i"),
        ("#:", "ement", "", "m ə n t"),
        ("", "eful", "", "f ʊ l"),
        ("", "ee", "", "iː"),
        ("", "earn", "", "ɜː n"),
        (" ", "ear", "^", "ɜː"),
        ("", "ead", "", "ɛ d"),
        ("#:", "ea", " ", "i ə"),
        ("", "ea", "su", "ɛ"),
        ("", "ea", "", "iː"),
        ("", "eigh", "", "eɪ"),
        ("", "ei", "", "iː"),
        (" ", "eye", "", "aɪ"),
        ("", "ey", "", "i"),
        ("", "eu", "", "j uː"),
        ("", "e", "^%", "iː"),
        ("", "e", "^e ", "iː"),
        ("", "e", "", "ɛ"),
    ],
    "f": [
        ("", "ful", "", "f ʊ l"),
        ("", "ff", "", "f"),
        ("", "f", "", "f"),
    ],
    "g": [
        ("", "gh", "i", "ɡ"),  # ghillie-ish
        ("", "gh", "", ""),  # high, though (rough via lexicon)
        ("", "gg", "", "ɡ"),  # bigger, biggest (before the g+ soft rule)
        (" b#", "g", "", "ɡ"),
        ("", "g", "+", "dʒ"),
        ("", "great", "", "ɡ ɹ eɪ t"),
        ("#", "gh", "", ""),
        ("", "gn", " ", "n"),  # sign-ish final
        (" ", "gn", "", "n"),  # gnome
        ("", "g", "", "ɡ"),
    ],
    "h": [
        (" ", "hav", "", "h æ v"),
        (" ", "here", "", "h ɪ ɹ"),
        (" ", "hour", "", "aʊ ɚ"),
        ("", "how", "", "h aʊ"),
        ("", "h", "#", "h"),
        ("", "h", "", ""),
    ],
    "i": [
        (" ", "in", "", "ɪ n"),
        (" ", "i", " ", "aɪ"),
        ("", "in", "d", "aɪ n"),  # find, kind
        ("", "ier", "", "i ɚ"),
        ("#:r", "ied", "", "i d"),
        ("", "ied", " ", "aɪ d"),
        ("", "ien", "", "i ɛ n"),
        ("", "ie", "t", "aɪ ə"),
        (" :", "i", "%", "aɪ"),
        ("", "i", "%", "i"),
        ("", "ie", "", "iː"),
        ("", "i", "^+:#", "ɪ"),
        ("", "ir", "#", "aɪ ɹ"),
        ("", "iz", "%", "aɪ z"),
        ("", "is", "%", "aɪ z"),
        ("", "i", "d%", "aɪ"),
        ("+^", "i", "^+", "ɪ"),
        ("", "i", "t%", "aɪ"),
        ("#:^", "i", "^+", "ɪ"),
        ("", "i", "^+", "aɪ"),
        ("", "ir", "", "ɜː"),
        ("", "igh", "", "aɪ"),
        ("", "ild", "", "aɪ l d"),
        ("", "ign", " ", "aɪ n"),
        ("", "ign", "^", "aɪ n"),
        ("", "ign", "%", "aɪ n"),
        ("", "ique", "", "iː k"),
        ("", "i", "^e ", "aɪ"),
        ("", "io", "n", "ə"),  # -tion/-sion handled at t/s
        ("", "i", "", "ɪ"),
    ],
    "j": [("", "j", "", "dʒ")],
    "k": [
        (" ", "k", "n", ""),  # knee, know
        ("", "k", "", "k"),
    ],
    "l": [
        ("", "lo", "c#", "l oʊ"),
        ("l", "l", "", ""),
        ("#:^", "l", "%", "əl"),
        ("", "lead", "", "l iː d"),
        ("", "l", "", "l"),
    ],
    "m": [
        ("", "mb", " ", "m"),
        ("", "mm", "", "m"),
        ("", "m", "", "m"),
    ],
    "n": [
        ("e", "ng", "+", "n dʒ"),
        ("", "ng", "r", "ŋ ɡ"),
        ("", "ng", "#", "ŋ ɡ"),
        ("", "ngl", "%", "ŋ ɡ əl"),
        ("", "ng", "", "ŋ"),
        ("", "nk", "", "ŋ k"),
        (" ", "now", " ", "n aʊ"),
        ("", "nn", "", "n"),
        ("", "n", "", "n"),
    ],
    "o": [
        ("", "of", " ", "ʌ v"),
        ("", "orough", "", "ɜː oʊ"),
        ("#:", "or", " ", "ɚ"),
        ("#:", "ors", " ", "ɚ z"),
        ("", "or", "", "ɔː ɹ"),
        (" ", "one", "", "w ʌ n"),
        ("", "ow", " ", "oʊ"),
        ("", "ow", "^", "oʊ"),
        ("", "ow", "", "aʊ"),
        (" ", "over", "", "oʊ v ɚ"),
        ("", "ov", "", "ʌ v"),
        ("", "ol", "d", "oʊ l"),
        ("", "ought", "", "ɔː t"),
        ("", "ough", "", "ʌ f"),
        (" ", "ou", "", "aʊ"),
        ("h", "ou", "s#", "aʊ"),
        ("", "ous", "", "ə s"),
        ("", "our", "", "ɔː ɹ"),
        ("", "ould", "", "ʊ d"),
        ("^", "ou", "^l", "ʌ"),
        ("", "oup", "", "uː p"),
        ("", "ou", "", "aʊ"),
        ("", "oy", "", "ɔɪ"),
        ("", "oing", "", "oʊ ɪ ŋ"),
        ("", "oi", "", "ɔɪ"),
        ("", "oor", "", "ɔː ɹ"),
        ("", "ook", "", "ʊ k"),
        ("", "ood", "", "ʊ d"),
        ("", "oo", "", "uː"),
        ("", "o", "e", "oʊ"),
        ("", "o", " ", "oʊ"),
        ("", "oa", "", "oʊ"),
        (" ", "only", "", "oʊ n l i"),
        (" ", "once", "", "w ʌ n s"),
        ("", "on't", "", "oʊ n t"),
        ("c", "o", "n", "ɑː"),
        ("", "o", "ng", "ɔː"),
        (" :^", "o", "n", "ʌ"),
        ("i", "on", "", "ə n"),
        ("#:", "on", " ", "ə n"),
        ("#^", "on", "", "ə n"),
        ("", "o", "st ", "oʊ"),
        ("", "of", "^", "ɔː f"),
        ("", "other", "", "ʌ ð ɚ"),
        ("", "oss", " ", "ɔː s"),
        ("#:^", "om", "", "ʌ m"),
        ("", "o", "^%", "oʊ"),
        ("", "o", "^e ", "oʊ"),
        ("", "o", "", "ɑː"),
    ],
    "p": [
        ("", "ph", "", "f"),
        ("", "peop", "", "p iː p"),
        ("", "pow", "", "p aʊ"),
        ("", "put", " ", "p ʊ t"),
        ("", "pp", "", "p"),
        (" ", "p", "s", ""),  # psalm, psyche
        ("", "p", "", "p"),
    ],
    "q": [
        ("", "quar", "", "k w ɔː ɹ"),
        ("", "qu", "", "k w"),
        ("", "q", "", "k"),
    ],
    "r": [
        (" ", "re", "^#", "ɹ iː"),
        ("", "rr", "", "ɹ"),
        ("", "r", "", "ɹ"),
    ],
    "s": [
        ("", "sh", "", "ʃ"),
        ("#", "sion", "", "ʒ ə n"),
        ("", "some", "", "s ʌ m"),
        ("#", "sur", "#", "ʒ ɚ"),
        ("", "sur", "#", "ʃ ɚ"),
        ("#", "su", "#", "ʒ u"),
        ("#", "ssu", "#", "ʃ u"),
        ("#", "sed", " ", "z d"),
        ("#", "s", "#", "z"),
        ("", "said", "", "s ɛ d"),
        ("^", "sion", "", "ʃ ə n"),
        ("", "ss", "", "s"),
        (".", "s", " ", "z"),
        ("#:.e", "s", " ", "z"),
        ("#:^##", "s", " ", "z"),
        ("#:^#", "s", " ", "s"),
        ("u", "s", " ", "s"),
        (" :#", "s", " ", "z"),
        (" ", "sch", "", "s k"),
        ("", "s", "c+", ""),
        ("#", "sm", "", "z m"),
        ("#", "sn", "'", "z ə n"),
        ("", "s", "", "s"),
    ],
    "t": [
        (" ", "the", " ", "ð ə"),
        ("", "to", " ", "t uː"),
        ("", "that", " ", "ð æ t"),
        (" ", "this", " ", "ð ɪ s"),
        (" ", "they", "", "ð eɪ"),
        (" ", "there", "", "ð ɛ ɹ"),
        ("", "ther", "", "ð ɚ"),
        ("", "their", "", "ð ɛ ɹ"),
        (" ", "than", " ", "ð æ n"),
        (" ", "them", " ", "ð ɛ m"),
        ("", "these", " ", "ð iː z"),
        (" ", "then", "", "ð ɛ n"),
        ("", "through", "", "θ ɹ uː"),
        ("", "those", "", "ð oʊ z"),
        ("", "though", " ", "ð oʊ"),
        (" ", "thus", "", "ð ʌ s"),
        ("", "th", "", "θ"),
        ("#:", "ted", " ", "t ɪ d"),
        ("s", "ti", "#n", "tʃ"),
        ("", "ti", "o", "ʃ"),
        ("", "ti", "a", "ʃ"),
        ("", "tien", "", "ʃ ə n"),
        ("", "tur", "#", "tʃ ɚ"),
        ("", "tu", "a", "tʃ u"),
        (" ", "two", "", "t uː"),
        ("", "tch", "", "tʃ"),
        ("", "tt", "", "t"),
        ("", "t", "", "t"),
    ],
    "u": [
        (" ", "un", "i", "j uː n"),
        (" ", "un", "", "ʌ n"),
        (" ", "upon", "", "ə p ɔː n"),
        ("t", "ur", "#", "ʊ ɹ"),
        ("s", "ur", "#", "ʊ ɹ"),
        ("r", "ur", "#", "ʊ ɹ"),
        ("d", "ur", "#", "ʊ ɹ"),
        ("l", "ur", "#", "ʊ ɹ"),
        ("z", "ur", "#", "ʊ ɹ"),
        ("n", "ur", "#", "ʊ ɹ"),
        ("j", "ur", "#", "ʊ ɹ"),
        ("th", "ur", "#", "ʊ ɹ"),
        ("ch", "ur", "#", "ʊ ɹ"),
        ("sh", "ur", "#", "ʊ ɹ"),
        ("", "ur", "#", "j ʊ ɹ"),
        ("", "ur", "", "ɜː"),
        ("", "u", "^ ", "ʌ"),
        ("", "u", "^^", "ʌ"),
        ("", "uy", "", "aɪ"),
        (" g", "u", "#", ""),
        ("g", "u", "%", ""),
        ("g", "u", "#", "w"),
        ("#n", "u", "", "j uː"),
        ("t", "u", "", "uː"),
        ("s", "u", "", "uː"),
        ("r", "u", "", "uː"),
        ("d", "u", "", "uː"),
        ("l", "u", "", "uː"),
        ("z", "u", "", "uː"),
        ("n", "u", "", "uː"),
        ("j", "u", "", "uː"),
        ("th", "u", "", "uː"),
        ("ch", "u", "", "uː"),
        ("sh", "u", "", "uː"),
        ("", "u", "", "j uː"),
    ],
    "v": [
        ("", "view", "", "v j uː"),
        ("", "v", "", "v"),
    ],
    "w": [
        (" ", "were", "", "w ɜː"),
        ("", "wa", "s", "w ʌ"),
        ("", "wa", "t", "w ɑː"),
        ("", "where", "", "w ɛ ɹ"),
        ("", "what", "", "w ʌ t"),
        ("", "whol", "", "h oʊ l"),
        ("", "who", "", "h uː"),
        ("", "wh", "", "w"),
        ("", "war", "", "w ɔː ɹ"),
        ("", "wor", "^", "w ɜː"),
        ("", "wr", "", "ɹ"),
        ("", "w", "", "w"),
    ],
    "x": [
        (" ", "x", "", "z"),  # xylophone
        ("", "x", "", "k s"),
    ],
    "y": [
        ("", "young", "", "j ʌ ŋ"),
        (" ", "you", "", "j uː"),
        (" ", "yes", "", "j ɛ s"),
        (" ", "y", "", "j"),
        ("#:^", "y", " ", "i"),
        ("#:^", "y", "i", "i"),
        (" :", "y", " ", "aɪ"),
        (" :", "y", "#", "aɪ"),
        (" :", "y", "^+:#", "ɪ"),
        (" :", "y", "^#", "aɪ"),
        ("", "y", "", "ɪ"),
    ],
    "z": [
        ("", "zz", "", "z"),
        ("", "z", "", "z"),
    ],
}


def _is_vowel(c: str) -> bool:
    return c in _VOWELS


def _match_left(word: str, pos: int, ctx: str) -> bool:
    """Match ``ctx`` (read right-to-left) against word[:pos]."""
    i = pos
    for c in reversed(ctx):
        if c == " ":
            if i != 0:
                return False
        elif c == "#":
            if i == 0 or not _is_vowel(word[i - 1]):
                return False
            i -= 1
            while i > 0 and _is_vowel(word[i - 1]):
                i -= 1
        elif c == ":":
            while i > 0 and word[i - 1] in _CONS:
                i -= 1
        elif c == "^":
            if i == 0 or word[i - 1] not in _CONS:
                return False
            i -= 1
        elif c == ".":
            if i == 0 or word[i - 1] not in _VOICED:
                return False
            i -= 1
        elif c == "+":
            if i == 0 or word[i - 1] not in _FRONT:
                return False
            i -= 1
        else:
            if i == 0 or word[i - 1] != c:
                return False
            i -= 1
    return True


_SUFFIXES = ("e", "er", "es", "ed", "ing", "ely")


def _match_right(word: str, pos: int, ctx: str) -> bool:
    """Match ``ctx`` (left-to-right) against word[pos:]."""
    i = pos
    n = len(word)
    for c in ctx:
        if c == " ":
            if i != n:
                return False
        elif c == "#":
            if i >= n or not _is_vowel(word[i]):
                return False
            i += 1
            while i < n and _is_vowel(word[i]):
                i += 1
        elif c == ":":
            while i < n and word[i] in _CONS:
                i += 1
        elif c == "^":
            if i >= n or word[i] not in _CONS:
                return False
            i += 1
        elif c == ".":
            if i >= n or word[i] not in _VOICED:
                return False
            i += 1
        elif c == "+":
            if i >= n or word[i] not in _FRONT:
                return False
            i += 1
        elif c == "%":
            rest = word[i:]
            if not any(rest.startswith(s) for s in _SUFFIXES):
                return False
            # consume the longest matching suffix
            i += max(len(s) for s in _SUFFIXES if rest.startswith(s))
        else:
            if i >= n or word[i] != c:
                return False
            i += 1
    return True


def _apply_rules(word: str) -> List[str]:
    """Letter-to-sound pass over one lowercase a-z(')-only word."""
    phones: List[str] = []
    pos = 0
    n = len(word)
    while pos < n:
        ch = word[pos]
        if ch == "'":
            pos += 1
            continue
        rules = _RULES_RAW.get(ch)
        if rules is None:  # non-alphabetic residue: skip
            pos += 1
            continue
        for left, match, right, out in rules:
            if not word.startswith(match, pos):
                continue
            if not _match_left(word, pos, left):
                continue
            if not _match_right(word, pos + len(match), right):
                continue
            if out:
                phones.extend(out.split())
            pos += len(match)
            break
        else:  # no rule matched (can't happen: every letter has a default)
            pos += 1
    return phones


def word_to_phones(word: str) -> List[str]:
    """English word → IPA phone list (lexicon first, LTS rules otherwise).

    Plural/past/possessive forms of lexicon words inflect on the lexicon
    entry (walks → walk + s) with voicing assimilation, so the exception
    lexicon covers far more surface forms than its entry count."""
    w = word.lower()
    hit = _LEXICON.get(w)
    if hit is not None:
        return list(hit)
    # simple inflections of lexicon words
    if len(w) > 2 and w.endswith("'s") and w[:-2] in _LEXICON:
        base = list(_LEXICON[w[:-2]])
        return base + (["ɪ", "z"] if base[-1] in _SIBILANT else
                       ["z"] if base[-1] in _VOICED_PH else ["s"])
    if len(w) > 1 and w.endswith("s") and w[:-1] in _LEXICON:
        base = list(_LEXICON[w[:-1]])
        return base + (["ɪ", "z"] if base[-1] in _SIBILANT else
                       ["z"] if base[-1] in _VOICED_PH else ["s"])
    if len(w) > 2 and w.endswith("ed") and w[:-2] in _LEXICON:
        base = list(_LEXICON[w[:-2]])
        return base + (["ɪ", "d"] if base[-1] in ("t", "d") else
                       ["d"] if base[-1] in _VOICED_PH else ["t"])
    if len(w) > 3 and w.endswith("ing") and w[:-3] in _LEXICON:
        return list(_LEXICON[w[:-3]]) + ["ɪ", "ŋ"]
    return _apply_rules(w)


# phone classes for inflection voicing
_SIBILANT = {"s", "z", "ʃ", "ʒ", "tʃ", "dʒ"}
_VOICED_PH = {"b", "d", "ɡ", "v", "ð", "z", "ʒ", "dʒ", "m", "n", "ŋ", "l",
              "ɹ", "w", "j", "iː", "ɪ", "eɪ", "ɛ", "æ", "ɑː", "ɔː", "oʊ",
              "ʊ", "uː", "ʌ", "ə", "ɚ", "ɜː", "aɪ", "aʊ", "ɔɪ", "i", "u"}

def phonemize_tokens(text: str) -> List[str]:
    """Text → token list in the espeak-wrapper grammar
    (``tokenizer.TextTokenizer.to_list``): per-word IPA phones, ``_``
    between words, punctuation as its own token. Digits should be expanded
    to words upstream (``numwords.replace_numbers_with_words``); stray
    digit runs fall back to per-character tokens rather than vanishing.
    Delegates to the shared separator-grammar walker
    (``latin_ipa.phonemize_tokens_with`` — one implementation of the
    contract for every builtin G2P; words the rules can't phonemize at
    all degrade to char tokens instead of dropping from the audio)."""
    from lemas_tts_tpu_torch.text.latin_ipa import phonemize_tokens_with

    return phonemize_tokens_with(word_to_phones, text)


def txt2phone(text: str) -> str:
    """Drop-in builtin analogue of ``tokenizer.txt2phone`` for English:
    ``|``-joined phone string preserving ``#1``-``#4`` pause markers and mapping
    CJK punctuation to ASCII."""
    from lemas_tts_tpu_torch.text.tokenizer import PAUSE_TOKENS, _PAUSE_SYMBOL, split_pauses

    text = re.sub("|".join(_PAUSE_SYMBOL),
                  lambda m: _PAUSE_SYMBOL[m.group(0)], text)
    phones: List[str] = []
    for part in split_pauses(text):
        if part in PAUSE_TOKENS:
            phones.append(part)
        elif part:
            phones += phonemize_tokens(part)
    return "|".join(phones)


def supports(lang: str) -> bool:
    """Languages this builtin G2P can phonemize (en only)."""
    return lang == "en"
