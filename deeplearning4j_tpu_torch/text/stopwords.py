"""English stop words (ref: text/stopwords/StopWords.java, which loads a
bundled stopwords resource file)."""

_ENGLISH = """a an and are as at be but by for from had has have he her his
i in is it its of on or she that the their them they this to was were what
which who will with you your we our us me my mine him himself herself
itself themselves do does did doing would should could ought not no nor so
than too very can just don t s about above after again against all am any
because been before being below between both down during each few further
here how into more most off once only other out over own same some such
then there these those through under until up when where why if while""".split()


class StopWords:
    _words = set(_ENGLISH)

    @classmethod
    def get_stop_words(cls):
        return sorted(cls._words)

    @classmethod
    def is_stop_word(cls, token: str) -> bool:
        return token.lower() in cls._words
