"""LLM-judge Elo evaluation: pairwise judge prompt + rating computation.

The judge prompt reproduces the reference's evaluation protocol verbatim
(``tools/elo_score_prompt.py:1-89``) — it defines the benchmark contract
(content-accuracy-only, tie-biased, image-handling ignored; judge model was
Gemini 3 Flash per ``README.md:111``). The reference ships only the prompt;
this module adds the rating harness: Elo updates with tie support and a
round-robin pairing runner over page outputs.
"""

from __future__ import annotations

import itertools
import json
import random
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


def construct_prompt(c1_text: str, c2_text: str) -> str:
    """Judge prompt comparing two models' markdown for one page."""

    prompt = f"""You are an expert in evaluating OCR content accuracy. Please compare the model outputs with the original image, focusing heavily on **content accuracy** while ignoring formatting and layout differences.

【Evaluation Focus - Focus ONLY on Content Accuracy】
1. **Text Accuracy**:
   - Typos: Character recognition errors (e.g., "test" recognized as "tost").
   - Omissions: Missing characters or words present in the original text.
   - Hallucinations: Adding characters that do not exist in the original text.

2. **Table Accuracy**:
   - Correctness of data and text within the table.
   - Completeness of cell content.
   - Correct row/column alignment.

3. **Formula Accuracy** (Evaluate based on):
   - **Correctness**: Are mathematical symbols, variables, and operators preserved accurately?
   - **Completeness**: Are all parts of the formula present without omission?
   - **Semantic Equivalence**: Does the extracted formula convey the exact same mathematical meaning?

【Tie Judgment Criteria - Important】
You must judge as a **tie** in the following cases:
- Text content is identical, differing only in Markdown formatting.
- Table data is identical, differing only in Markdown table syntax.
- Formula content is semantically equivalent, differing only in LaTeX representation.
- Both models correctly identified the core content; minor differences do not affect information retrieval.
- Both models share the same minor errors or are both perfect.
- **Image/Figure processing differs** (one extracts text, one gives bbox, one ignores it), but the main text is accurate.

【Items to Ignore - Do NOT factor into scoring】
- Markdown formatting differences (e.g., `# Header` vs `## Header`, `*` vs `-` for lists).
- Layout and typesetting differences (newlines, indentation, alignment).
- Recognition differences in non-body text like Headers, Footers, and Page Numbers.
- Text wrapping and paragraph segmentation nuances.
- Table border styles (e.g., `|---|---|` vs `|:--|--:|`).
- Different but equivalent LaTeX representations for formulas.
- **Image/Figure Processing Differences (ABSOLUTELY IGNORE)**:
  - How the model parses image/figure regions is **completely excluded** from the scoring standard.
  - Whether it parses as a `figure` field, outputs bbox coordinates, extracts text inside the image, provides a caption, describes the image content, or **completely ignores/skips the image**, these are all considered equivalent.
  - Do NOT declare a winner based on image handling.

【Model 1 Output】:
```markdown
{c1_text}
```

【Model 2 Output】:
```markdown
{c2_text}
```

【Evaluation Process】
1. Carefully compare the text content against the original image.
2. Identify errors, omissions, or additions in text recognition for both models.
3. Check the accuracy of table data.
4. Evaluate the correctness, completeness, and semantic equivalence of mathematical formulas.
5. **Ignore image regions**: Confirm that differences in image/figure parsing are not used for scoring.
6. Important: If the substance is the same and only the format differs, judge as a tie.
7. Only declare a winner if there is a significant difference in **content accuracy**.

【Examples of Ties】
- Model 1: "# Title", Model 2: "## Title" (Same content, different level).
- Model 1: "* Item", Model 2: "- Item" (Same content, different bullet).
- Formula: Model 1 "$x^2$", Model 2 "$x*x$" (Different LaTeX, same meaning).
- Table data is identical, but column alignment syntax differs.
- Identification is identical, but one model parsed the footer while the other didn't (Judge as Tie).
- **Image handling**: Model 1 outputs an image bbox, Model 2 outputs an image description, Model 3 ignores the image. As long as the main text is accurate, this is a **Tie**.

【Output Requirement】 Please strictly return the result in the following JSON format:

{{"winner": "tie", "reason": "Detailed explanation of the judgment, specifically noting the logic for a tie"}}

The value of "winner" must be one of:
- "1": Model 1 is clearly better in content accuracy.
- "2": Model 2 is clearly better in content accuracy.
- "tie": Both models perform equally in content accuracy (including cases of identical content but different formatting/image handling).

In the "reason" field, specifically explain:
- If a tie: Explain the consistency of the content and explicitly mention which formatting or image handling differences were ignored.
- If a winner: Specifically point out the accuracy differences (typos, missing words, table/formula errors).
- **Note**: It is better to judge a tie than to incorrectly determine a winner based on minor formatting or image parsing differences. **Content accuracy of the main text is the ONLY standard.**
"""
    return prompt


def parse_judge_response(text: str) -> Optional[str]:
    """Extract the winner ('1' | '2' | 'tie') from a judge response."""
    match = re.search(r'"winner"\s*:\s*"(1|2|tie)"', text)
    if match:
        return match.group(1)
    try:
        data = json.loads(text)
        winner = str(data.get("winner", "")).lower()
        if winner in ("1", "2", "tie"):
            return winner
    except Exception:  # noqa: BLE001
        pass
    return None


@dataclass
class EloRater:
    """Standard Elo with tie support (score 0.5)."""

    initial: float = 1000.0
    k_factor: float = 16.0
    ratings: Dict[str, float] = field(default_factory=dict)
    games: Dict[str, int] = field(default_factory=dict)

    def rating(self, model: str) -> float:
        return self.ratings.get(model, self.initial)

    def expected(self, a: str, b: str) -> float:
        return 1.0 / (1.0 + 10 ** ((self.rating(b) - self.rating(a)) / 400.0))

    def record(self, model_a: str, model_b: str, winner: str) -> None:
        """winner: '1' (model_a), '2' (model_b), or 'tie'."""
        score_a = {"1": 1.0, "2": 0.0, "tie": 0.5}[winner]
        ea = self.expected(model_a, model_b)
        ra = self.rating(model_a) + self.k_factor * (score_a - ea)
        rb = self.rating(model_b) + self.k_factor * ((1.0 - score_a) - (1.0 - ea))
        self.ratings[model_a] = ra
        self.ratings[model_b] = rb
        self.games[model_a] = self.games.get(model_a, 0) + 1
        self.games[model_b] = self.games.get(model_b, 0) + 1

    def leaderboard(self) -> List[Tuple[str, float]]:
        return sorted(self.ratings.items(), key=lambda kv: -kv[1])


def run_elo_tournament(
    outputs: Dict[str, Dict[str, str]],
    judge: Callable[[str], str],
    rounds: int = 1,
    seed: int = 0,
    rater: Optional[EloRater] = None,
) -> EloRater:
    """Round-robin pairwise judging.

    outputs: {model_name: {page_id: markdown}}; judge: prompt -> raw judge
    response text. Pages are shuffled per round; model order within each
    pair is randomized to cancel position bias.
    """
    rater = rater or EloRater()
    rng = random.Random(seed)
    models = sorted(outputs)
    shared_pages = set.intersection(*(set(outputs[m]) for m in models)) if models else set()
    for _ in range(rounds):
        pages = sorted(shared_pages)
        rng.shuffle(pages)
        for page in pages:
            for m1, m2 in itertools.combinations(models, 2):
                a, b = (m1, m2) if rng.random() < 0.5 else (m2, m1)
                response = judge(construct_prompt(outputs[a][page], outputs[b][page]))
                winner = parse_judge_response(response)
                if winner is None:
                    continue
                rater.record(a, b, winner)
    return rater
